"""Visualization: BEV prediction review, 2D image boxes, and 3D
point-cloud scenes (matplotlib).

Replaces the reference's viz stack (viz/prediction_review.py BEV pngs,
demos/show_predictions_2d.py, and the mayavi point-cloud viewers
viz/viz_utils.py:1-30 / viz/viz_func.py) without the mayavi dependency:
`draw_point_cloud_3d` renders the lidar cloud height-colored with GT /
predicted 3D wireframe boxes and optional per-track coloring through
matplotlib's 3D axes.

The port's copy of dodt_tpu/viz.py.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from dodt_tpu_torch.utils.np_iou import box_3d_corners


def _rect_xz(box_3d):
    c = box_3d_corners(np.asarray(box_3d, float))[:4]
    return c[:, [0, 2]]


def draw_bev(bev_features: np.ndarray, area_extents,
             gt_boxes: Optional[np.ndarray] = None,
             pred_boxes: Optional[np.ndarray] = None,
             scores: Optional[np.ndarray] = None,
             path: Optional[str] = None):
    """Render the density channel with GT (green) and predicted (red)
    footprints. bev_features: (H, W, C) with density last."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ae = np.asarray(area_extents, float)
    fig, ax = plt.subplots(figsize=(10, 9))
    ax.imshow(bev_features[..., -1], cmap="magma",
              extent=[ae[0][0], ae[0][1], ae[2][0], ae[2][1]],
              origin="upper", aspect="auto")

    def plot_boxes(boxes, color, labels=None):
        for i, b in enumerate(boxes):
            pts = _rect_xz(b)
            poly = np.vstack([pts, pts[:1]])
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.2)
            if labels is not None:
                ax.text(pts[0, 0], pts[0, 1], f"{labels[i]:.2f}",
                        color=color, fontsize=6)

    if gt_boxes is not None and len(gt_boxes):
        plot_boxes(gt_boxes, "lime")
    if pred_boxes is not None and len(pred_boxes):
        plot_boxes(pred_boxes, "red", scores)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def draw_image_boxes(image: np.ndarray, boxes_2d: List,
                     scores: Optional[List] = None,
                     path: Optional[str] = None):
    """2D prediction review (reference demos/show_predictions_2d.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.patches as patches

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(image.astype(np.uint8))
    for i, bb in enumerate(boxes_2d):
        x1, y1, x2, y2 = bb
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, fill=False, color="red",
            linewidth=1.2))
        if scores is not None:
            ax.text(x1, y1 - 2, f"{scores[i]:.2f}", color="red",
                    fontsize=7)
    ax.axis("off")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


# 12 edges of a box from the (8, 3) corner layout of box_3d_corners
# (bottom face 0-3, top face 4-7, verticals i -> i+4)
_BOX_EDGES = ([(i, (i + 1) % 4) for i in range(4)] +
              [(i + 4, (i + 1) % 4 + 4) for i in range(4)] +
              [(i, i + 4) for i in range(4)])


def draw_point_cloud_3d(points: np.ndarray,
                        gt_boxes: Optional[np.ndarray] = None,
                        pred_boxes: Optional[np.ndarray] = None,
                        track_ids: Optional[np.ndarray] = None,
                        scores: Optional[np.ndarray] = None,
                        max_points: int = 60000,
                        elev: float = 18.0, azim: float = -95.0,
                        path: Optional[str] = None):
    """3D point-cloud scene review — the matplotlib replacement for the
    reference's mayavi viewers (viz/viz_utils.py draw_lidar +
    draw_gt_boxes3d, viz/demo.py).

    points: (N, 3+) camera-frame xyz (extra columns ignored), colored by
    height (-y, i.e. up). gt_boxes / pred_boxes: (M, 7) box_3d rows
    drawn as green / red wireframes; with `track_ids`, predictions are
    colored per track identity instead (tracklet review, reference
    viz/stack_viz_test.py usage). `scores` labels predictions.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points, float)[:, :3]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(
            len(pts), max_points, replace=False)]
    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(projection="3d")
    # camera frame: x right, y down, z forward -> plot (x, z, -y)
    ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.3, c=-pts[:, 1],
               cmap="viridis", linewidths=0)

    def wire(box, color, label=None):
        c = box_3d_corners(np.asarray(box, float))
        for i, j in _BOX_EDGES:
            ax.plot([c[i, 0], c[j, 0]], [c[i, 2], c[j, 2]],
                    [-c[i, 1], -c[j, 1]], color=color, linewidth=1.3)
        if label is not None:
            ax.text(c[4, 0], c[4, 2], -c[4, 1], label, color=color,
                    fontsize=7)

    if gt_boxes is not None:
        for b in np.atleast_2d(gt_boxes):
            wire(b, "lime")
    if pred_boxes is not None:
        pred_boxes = np.atleast_2d(pred_boxes)
        cmap = plt.get_cmap("tab10")
        for i, b in enumerate(pred_boxes):
            color = (cmap(int(track_ids[i]) % 10)
                     if track_ids is not None else "red")
            label = (f"{scores[i]:.2f}" if scores is not None
                     else (f"id {int(track_ids[i])}"
                           if track_ids is not None else None))
            wire(b, color, label)

    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_zlabel("up (m)")
    # equal aspect so boxes are not sheared
    spans = np.ptp(pts, axis=0)
    ax.set_box_aspect((spans[0], spans[2], max(spans[1], 1e-3)))
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
