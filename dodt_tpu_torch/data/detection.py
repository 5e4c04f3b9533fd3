"""Single-frame KITTI detection dataset (reference
avod/datasets/kitti/kitti_dataset.py:25).

Produces the same fixed-shape sample dicts as the tracking dataset but
with a frame axis of size 1, so the same DtAvodNet (num_frames=1) and
trainer/evaluator run unchanged on the detection task.

Layout: <dataset_dir>/<data_split_dir>/{velodyne,image_2,calib,label_2,
planes}/<sample>.{bin,png,txt}; split files <dataset_dir>/<split>.txt
with one sample name per line.

The port's copy of dodt_tpu/data/detection.py. Its one change: the
camera image is read and resized in ``KittiDataset._camera_image``, the
only place that needs cv2, so a dataset without PNG files (or a machine
without cv2) overrides that method alone.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dodt_tpu_torch.config import DatasetConfig
from dodt_tpu_torch.data import augment as aug
from dodt_tpu_torch.data import kitti
from dodt_tpu_torch.data.tracking import stack_samples


class KittiDataset:
    def __init__(self, cfg: DatasetConfig, split: Optional[str] = None):
        self.cfg = cfg
        self.split = split or cfg.data_split
        base = os.path.join(cfg.dataset_dir, cfg.data_split_dir)
        self.velo_dir = os.path.join(base, "velodyne")
        self.image_dir = os.path.join(base, "image_2")
        self.calib_dir = os.path.join(base, "calib")
        self.label_dir = os.path.join(base, "label_2")
        self.planes_dir = os.path.join(base, "planes")
        self.has_labels = os.path.isdir(self.label_dir)

        with open(os.path.join(cfg.dataset_dir,
                               self.split + ".txt")) as f:
            self.sample_names = [ln.strip() for ln in f if ln.strip()]

        self._epoch_order = np.arange(len(self.sample_names))
        self._epoch_pos = 0
        self._rng = np.random.RandomState(0)

    def __len__(self):
        return len(self.sample_names)

    def class_index(self, type_str: str) -> int:
        return self.cfg.classes.index(type_str) + 1

    def _camera_image(self, name: str):
        """(original (H, W), the RGB image resized to cfg.image_shape as
        uint8) of one sample's camera image."""
        import cv2

        img = cv2.imread(os.path.join(self.image_dir, name + ".png"))
        img = img[..., ::-1]
        ih, iw = self.cfg.image_shape
        return img.shape[:2], cv2.resize(img, (iw, ih))  # uint8

    def load_sample(self, idx: int, augs: tuple = (),
                    rng=None) -> dict:
        rng = rng or self._rng
        name = self.sample_names[idx]
        calib = kitti.read_calibration(self.calib_dir, name)
        p2 = calib.p2.copy()

        orig_shape, img = self._camera_image(name)

        velo = kitti.read_lidar(self.velo_dir, name)[:, :3]
        cam = kitti.lidar_to_cam_frame(velo, calib).astype(np.float32)
        cam = cam[kitti.filter_to_image_fov(cam, calib, orig_shape)]

        try:
            gp = kitti.read_ground_plane(self.planes_dir, name)
        except FileNotFoundError:
            gp = kitti.DEFAULT_GROUND_PLANE.copy()

        labels = None
        if self.has_labels:
            labels = kitti.filter_labels(
                kitti.read_labels(self.label_dir, name),
                self.cfg.classes)

        if aug.AUG_FLIPPING in augs:
            img = aug.flip_image(img).copy()
            cam = aug.flip_points(cam)
            if labels is not None:
                labels = labels.select(np.ones(len(labels), bool))
                labels.box_3d = aug.flip_boxes_3d(labels.box_3d)
            gp = aug.flip_ground_plane(gp)
            p2 = aug.flip_calib_p2(p2, orig_shape)
        if aug.AUG_PCA_JITTER in augs:
            img = aug.pca_jitter(img, rng)

        p = self.cfg.max_points
        n = len(cam)
        pts = np.zeros((p, 3), np.float32)
        valid = np.zeros(p, bool)
        if n >= p:
            sel = rng.choice(n, p, replace=False)
            pts[:] = cam[sel]
            valid[:] = True
        else:
            pts[:n] = cam
            valid[:n] = True

        out = {
            "points": pts[None],                       # (1, P, 3)
            "points_valid": valid[None],
            "image": img[None],
            "ground_plane": gp.astype(np.float32),
            "p2": p2.astype(np.float32),
            "orig_image_shape": np.array(orig_shape, np.int32),
        }
        if labels is not None:
            g = self.cfg.max_gt_boxes
            boxes = np.zeros((1, g, 7), np.float32)
            classes = np.zeros((1, g), np.int32)
            lvalid = np.zeros((1, g), bool)
            nl = min(len(labels), g)
            boxes[0, :nl] = labels.box_3d[:nl]
            classes[0, :nl] = [self.class_index(t)
                               for t in labels.types[:nl]]
            lvalid[0, :nl] = True
            out.update({
                "gt_boxes": boxes, "gt_classes": classes,
                "gt_valid": lvalid,
                "gt_track_ids": np.full((1, g), -1, np.int32),
                "corr_offsets": np.zeros((g, 3), np.float32),
                "corr_coexist": np.zeros(g, bool),
            })
        out["sample_name"] = name
        return out

    def next_batch(self, batch_size: int, shuffle: bool = True,
                   augment: bool = True) -> dict:
        idxs = []
        for _ in range(batch_size):
            if self._epoch_pos == 0 and shuffle:
                self._rng.shuffle(self._epoch_order)
            idxs.append(self._epoch_order[self._epoch_pos])
            self._epoch_pos = (self._epoch_pos + 1) % len(self)
        samples = []
        for i in idxs:
            augs = ()
            if augment:
                if aug.AUG_FLIPPING in self.cfg.aug_list and \
                        self._rng.rand() < 0.5:
                    augs += (aug.AUG_FLIPPING,)
                if aug.AUG_PCA_JITTER in self.cfg.aug_list and \
                        self._rng.rand() < 0.5:
                    augs += (aug.AUG_PCA_JITTER,)
            samples.append(self.load_sample(int(i), augs))
        return stack_samples(samples)
