"""N-frame stacked tracking dataset (integrated point cloud).

Parity target: reference KittiTrackingStackDataset
(kitti_tracking_stack_dataset.py:29): a keyframe couple (t, t+tau) is
expanded to ALL intermediate frames; every frame's cloud is ego-aligned
into frame-t coordinates; the integrated cloud is their concatenation
(:632); labels of the same object across frames merge into a hull box
via box_4c min/max (:422-488); per-frame label masks and coexist flags
(0 = in both keyframes, -1 = only first, +1 = only last) drive the
stack correlation head.

Per-frame padded clouds (F, P, 3) go to the device; the integrated cloud
is just a reshape (F*P points), no host concat pass.

The port's copy of dodt_tpu/data/stack.py. Its one change: each frame's
camera image comes from the inherited ``_camera_image(video_id, frame)``
(data/tracking.py), the only place that needs cv2.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dodt_tpu_torch.config import DatasetConfig
from dodt_tpu_torch.data import augment as aug
from dodt_tpu_torch.data import kitti
from dodt_tpu_torch.data.tracking import KittiTrackingDataset, stack_samples
from dodt_tpu_torch.utils.np_iou import box_3d_corners


def merge_track_boxes(boxes: np.ndarray) -> np.ndarray:
    """Merge one object's boxes over frames into a hull box_3d:
    footprint = min/max over all corners (axis-aligned to the first
    box's heading), heights = min/max (reference merge_labels:422
    box_4c min/max semantics)."""
    ry = boxes[0, 6]
    c, s = np.cos(-ry), np.sin(-ry)
    xs, zs, y_lo, y_hi = [], [], [], []
    for b in boxes:
        corners = box_3d_corners(b)[:4]           # bottom face
        # rotate into the first box's frame
        x = c * (corners[:, 0] - boxes[0, 0]) + \
            s * (corners[:, 2] - boxes[0, 2])
        z = -s * (corners[:, 0] - boxes[0, 0]) + \
            c * (corners[:, 2] - boxes[0, 2])
        xs.extend(x)
        zs.extend(z)
        y_lo.append(b[1] - b[5])
        y_hi.append(b[1])
    x1, x2 = min(xs), max(xs)
    z1, z2 = min(zs), max(zs)
    cx_l = (x1 + x2) / 2.0
    cz_l = (z1 + z2) / 2.0
    # back to world
    cw, sw = np.cos(ry), np.sin(ry)
    cx = cw * cx_l + sw * cz_l + boxes[0, 0]
    cz = -sw * cx_l + cw * cz_l + boxes[0, 2]
    y = max(y_hi)
    h = y - min(y_lo)
    return np.array([cx, y, cz, x2 - x1, z2 - z1, h, ry], np.float32)


class KittiTrackingStackDataset(KittiTrackingDataset):
    """Extends the pair dataset: loads all frames in [t, t+tau]."""

    def __init__(self, cfg: DatasetConfig, split: Optional[str] = None):
        super().__init__(cfg, split)
        self.num_frames = cfg.data_stride + 1

    def load_stack(self, idx: int, augs: tuple = (), rng=None) -> dict:
        cp = self.couples[idx]
        rng = rng or self._rng
        calib = self.calib(cp.video_id)
        # static frame count = stride + 1; clamp at the video end
        # (last-frame duplication like generate_sample_couple)
        frames = [min(cp.frame_a + i, max(cp.frame_b, cp.frame_a))
                  for i in range(self.num_frames)]
        n = len(frames)

        oxts0 = kitti.read_oxts(self.oxts_dir, cp.video_id, cp.frame_a)
        gp = self.ground_plane(cp.video_id, cp.frame_a)

        pts_list, images, labels = [], [], []
        orig_shape = None
        for i, frame in enumerate(frames):
            hw, img = self._camera_image(cp.video_id, frame)
            if orig_shape is None:
                orig_shape = hw
            velo = kitti.read_lidar(
                os.path.join(self.velo_dir, f"{cp.video_id:04d}"),
                f"{frame:06d}")[:, :3]
            lab = self.labels(cp.video_id, frame) if self.has_labels \
                else None
            if i > 0:
                oxts_i = kitti.read_oxts(self.oxts_dir, cp.video_id,
                                         frame)
                trans, matrix, dyaw = kitti.ego_motion(oxts0, oxts_i)
                velo = kitti.transform_points_to_prev_frame(
                    velo, trans, matrix)
                if lab is not None and len(lab):
                    lab = kitti.transform_labels_to_prev_frame(
                        lab, calib, trans, matrix, dyaw)
            cam = kitti.lidar_to_cam_frame(velo, calib).astype(
                np.float32)
            cam = cam[kitti.filter_to_image_fov(cam, calib, orig_shape)]
            pts_list.append(cam)
            images.append(img)
            labels.append(lab)

        # ---- augment (same surface as the couple path, applied after
        # ego alignment so every frame flips consistently — reference
        # kitti_aug.py flip family + PCA jitter)
        p2 = calib.p2.copy()
        if aug.AUG_FLIPPING in augs:
            images = [aug.flip_image(im).copy() for im in images]
            pts_list = [aug.flip_points(p) for p in pts_list]
            labels = [self._flip_labels(l) if l is not None else None
                      for l in labels]
            gp = aug.flip_ground_plane(gp)
            p2 = aug.flip_calib_p2(p2, orig_shape)
        if aug.AUG_PCA_JITTER in augs:
            images = [aug.pca_jitter(im, rng) for im in images]

        padded = [self._pad_points(p, rng) for p in pts_list]
        out = {
            "points": np.stack([p for p, _ in padded]),  # (F, P, 3)
            "points_valid": np.stack([v for _, v in padded]),
            "image": np.stack(images),
            "ground_plane": gp.astype(np.float32),
            "p2": p2.astype(np.float32),
            "orig_image_shape": np.array(orig_shape, np.int32),
        }
        if self.has_labels:
            out.update(self._stack_labels(labels, n))
        out["sample_name"] = cp.name
        return out

    def _stack_labels(self, labels, n):
        g = self.cfg.max_gt_boxes
        boxes = np.zeros((n, g, 7), np.float32)
        classes = np.zeros((n, g), np.int32)
        valid = np.zeros((n, g), bool)
        tids = np.full((n, g), -1, np.int32)
        for i, lab in enumerate(labels):
            m = min(len(lab), g)
            boxes[i, :m] = lab.box_3d[:m]
            classes[i, :m] = [self.class_index(t)
                              for t in lab.types[:m]]
            valid[i, :m] = True
            tids[i, :m] = lab.track_ids[:m]

        # merged hull labels over all frames, keyed by track id
        merged = np.zeros((g, 7), np.float32)
        merged_cls = np.zeros(g, np.int32)
        merged_valid = np.zeros(g, bool)
        coexist = np.zeros(g, np.float32)   # 0 both, -1 first only,
        corr = np.zeros((g, 3), np.float32)  # +1 last only
        all_ids = sorted({int(t) for i in range(n)
                          for t in tids[i][valid[i]]})[:g]
        for j, tid in enumerate(all_ids):
            per_frame = [boxes[i][np.where((tids[i] == tid) &
                                           valid[i])[0]]
                         for i in range(n)]
            present = [len(pf) > 0 for pf in per_frame]
            stack = np.concatenate([pf for pf in per_frame
                                    if len(pf)])
            merged[j] = merge_track_boxes(stack)
            idx0 = int(np.argmax(present))
            merged_cls[j] = classes[idx0][
                np.where((tids[idx0] == tid) & valid[idx0])[0][0]]
            merged_valid[j] = True
            first, last = present[0], present[-1]
            if first and last:
                coexist[j] = 0.0
                b0 = per_frame[0][0]
                b1 = per_frame[-1][0]
                corr[j] = [b1[0] - b0[0], b1[2] - b0[2],
                           b1[6] - b0[6]]
            elif first:
                coexist[j] = -1.0
            else:
                coexist[j] = 1.0

        return {
            "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid, "gt_track_ids": tids,
            "merged_boxes": merged, "merged_classes": merged_cls,
            "merged_valid": merged_valid,
            "coexist": coexist, "corr_offsets": corr,
        }

    def next_batch(self, batch_size: int, shuffle: bool = True,
                   augment: bool = False) -> dict:
        """Epoch-shuffled stack batches; with `augment`, each stack
        samples the configured aug list like the couple path
        (reference kitti_tracking_stack_dataset load path applies the
        same kitti_aug surface as the pair dataset)."""
        idxs = []
        for _ in range(batch_size):
            if self._epoch_pos == 0 and shuffle:
                self._rng.shuffle(self._epoch_order)
            idxs.append(self._epoch_order[self._epoch_pos])
            self._epoch_pos = (self._epoch_pos + 1) % len(self.couples)
        samples = []
        for i in idxs:
            augs = self._sample_augs() if augment else ()
            samples.append(self.load_stack(int(i), augs))
        return stack_samples(samples)
