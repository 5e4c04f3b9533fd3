"""KITTI prediction-file writer (bit-compatible output contract).

Produces the exact txt format consumed by the official KITTI offline
evaluators (reference dt_inference_utils.convert_pred_to_kitti_format:
135 and evaluator_utils.save_predictions_in_kitti_format:22):

  type trunc occ alpha x1 y1 x2 y2 h w l x y z ry score

with truncation/occlusion set to -1, alpha -10, boxes projected to the
image plane and clipped; fully-out-of-image boxes dropped.

The port's copy of dodt_tpu/eval/kitti_writer.py.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from dodt_tpu_torch.data.kitti import FrameCalib


def project_box_to_image(box_3d: np.ndarray, calib: FrameCalib,
                         image_size) -> Optional[np.ndarray]:
    """3D box -> clipped 2D image box; None if fully outside
    (reference wavedata box_3d_projector.project_to_image_space with
    truncate=True)."""
    x, y, z, l, w, h, ry = box_3d[:7]
    c, s = np.cos(ry), np.sin(ry)
    xc = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    zc = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    yc = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    corners = np.stack([c * xc + s * zc + x, yc + y,
                        -s * xc + c * zc + z], axis=1)
    if np.all(corners[:, 2] <= 0.1):
        return None
    corners = corners[corners[:, 2] > 0.1]
    uv = calib.project_rect_to_image(corners)
    img_w, img_h = image_size
    x1, y1 = uv.min(axis=0)
    x2, y2 = uv.max(axis=0)
    # discard boxes entirely outside the image
    if x2 < 0 or y2 < 0 or x1 > img_w or y1 > img_h:
        return None
    return np.array([max(x1, 0), max(y1, 0),
                     min(x2, img_w), min(y2, img_h)])


def predictions_to_kitti_lines(boxes_3d: np.ndarray, scores: np.ndarray,
                               class_indices: np.ndarray,
                               calib: FrameCalib, image_size,
                               classes=("Car",),
                               score_threshold: float = 0.1
                               ) -> List[str]:
    """Format predictions for one frame.

    Args:
      boxes_3d: (N, 7) [x, y, z, l, w, h, ry].
      scores: (N,), class_indices: (N,) 0-based into `classes`.
      image_size: (width, height).
    """
    lines = []
    for i in range(len(boxes_3d)):
        if scores[i] < score_threshold:
            continue
        img_box = project_box_to_image(boxes_3d[i], calib, image_size)
        if img_box is None:
            continue
        x, y, z, l, w, h, ry = np.round(boxes_3d[i][:7], 3)
        x1, y1, x2, y2 = np.round(img_box, 3)
        obj_type = classes[int(class_indices[i])]
        lines.append(
            f"{obj_type} -1 -1 -10 {x1:.3f} {y1:.3f} {x2:.3f} {y2:.3f} "
            f"{h:.3f} {w:.3f} {l:.3f} {x:.3f} {y:.3f} {z:.3f} "
            f"{ry:.3f} {scores[i]:.3f}")
    return lines


def write_kitti_file(path: str, lines: List[str]):
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


# ---------------------------------------------------------------------
# Extended per-couple contract: offsets + coexist round trip
# ---------------------------------------------------------------------
# The reference evaluator writes per-couple txt carrying the propagated
# box, coexist and frame-mark columns next to the plain KITTI files
# (dt_evaluator.get_avod_predicted_boxes_3d_and_scores:1134-1259), and
# its offline trackers re-read them (dt_tracking_eval.decode_tracking_
# file:80). Redesign here: absolute frame numbers instead of a 0/1
# mark, boxes already recovered into each frame's own coordinates
# (the in-memory contract of runtime/video.py), and the raw [dx dz dry]
# offsets + P(both) coexist written explicitly instead of a
# pre-propagated second box.
#
# Row format (whitespace-separated):
#   frame type score x y z l w h ry dx dz dry coexist span
# span -1 encodes "no offsets" (models without a correlation head);
# span 0 encodes offsets present but no explicit span.

def couple_detections_to_lines(dets_by_frame, classes=("Car",)
                               ) -> List[str]:
    lines = []
    for frame in sorted(dets_by_frame):
        for d in dets_by_frame[frame]:
            x, y, z, l, w, h, ry = [float(v) for v in d["box_3d"][:7]]
            off = d.get("offsets")
            if off is None:
                dx = dz = dry = 0.0
                span = -1
            else:
                dx, dz, dry = (float(off[0]), float(off[1]),
                               float(off[2]))
                span = int(d.get("offsets_span") or 0)
            coex = d.get("coexist")
            coex = 0.5 if coex is None else float(coex)
            obj_type = classes[int(d.get("class_idx", 0))] \
                if "class_idx" in d else d.get("type", classes[0])
            lines.append(
                f"{frame} {obj_type} {d['score']:.6f} "
                f"{x:.6f} {y:.6f} {z:.6f} {l:.6f} {w:.6f} {h:.6f} "
                f"{ry:.6f} {dx:.6f} {dz:.6f} {dry:.6f} {coex:.6f} "
                f"{span}")
    return lines


def parse_couple_lines(lines, classes=("Car",)):
    """Inverse of `couple_detections_to_lines`: {frame: [det dict]}."""
    out = {}
    for line in lines:
        p = line.split()
        if len(p) < 15:
            continue
        frame = int(p[0])
        span = int(p[14])
        det = {
            "frame_id": frame,
            "type": p[1],
            "class_idx": classes.index(p[1]) if p[1] in classes else 0,
            "score": float(p[2]),
            "box_3d": np.array([float(v) for v in p[3:10]]),
            "offsets": (None if span < 0 else
                        np.array([float(v) for v in p[10:13]])),
            "coexist": float(p[13]),
        }
        if span > 0:
            det["offsets_span"] = span
        out.setdefault(frame, []).append(det)
    return out
