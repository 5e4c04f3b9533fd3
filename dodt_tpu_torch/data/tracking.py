"""Paired-frame KITTI tracking dataset -> fixed-shape device batches.

TPU re-design of the reference KittiTrackingDataset
(kitti_tracking_dataset.py:25): the host side only reads files, applies
ego-motion compensation and augmentation, and pads everything to static
capacities; BEV rasterization, anchor filtering and target assignment
all happen on device (ops/voxel.py, ops/sampling.py). Batching is
first-class (the reference is locked to batch 1).

Sample-couple generation parity (generate_sample_couple:240): sliding
pairs (i, i+tau) for train, strided pairs for val/test, last frame
duplicated at the end of a video.

The port's copy of dodt_tpu/data/tracking.py. Its one change: the camera
image is read and resized in ``KittiTrackingDataset._camera_image``, the
only place that needs cv2, so a dataset without PNG files (or a machine
without cv2) overrides that method alone.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from dodt_tpu_torch.config import DatasetConfig
from dodt_tpu_torch.data import augment as aug
from dodt_tpu_torch.data import kitti


@dataclass
class SampleCouple:
    video_id: int
    frame_a: int
    frame_b: int
    augs: tuple = ()

    @property
    def name(self) -> str:
        return f"{self.video_id:02d}{self.frame_a:04d}_" \
               f"{self.video_id:02d}{self.frame_b:04d}"

    def frame_name(self, i: int) -> str:
        f = self.frame_a if i == 0 else self.frame_b
        return f"{self.video_id:02d}{f:04d}"


def generate_sample_couples(split_file: str, data_stride: int, split: str,
                            video_train_ids) -> List[SampleCouple]:
    """Parse the grouped split file into (frame, frame+tau) couples."""
    with open(split_file) as f:
        groups = [g for g in f.read().split("\n\n") if g.strip()]
    couples = []
    for group in groups:
        names = [ln for ln in group.split("\n") if ln.strip()]
        video_id = int(names[0].split("/")[0])
        frames = [int(n.split("/")[1]) for n in names]
        is_train_video = video_id in video_train_ids
        if split == "test":
            sliding = False
        elif split == "trainval":
            sliding = True
        elif split == "train":
            if not is_train_video:
                continue
            sliding = True
        elif split == "val":
            if is_train_video:
                continue
            sliding = False
        else:
            raise ValueError(split)
        rng = range(len(frames)) if sliding else \
            range(0, len(frames), data_stride)
        for i in rng:
            j = i + data_stride if i + data_stride < len(frames) else -1
            couples.append(SampleCouple(video_id, frames[i], frames[j]))
    return couples


def _first_existing_dir(base: str, *names: str) -> str:
    for n in names:
        p = os.path.join(base, n)
        if os.path.isdir(p):
            return p
    return os.path.join(base, names[0])


class KittiTrackingDataset:
    """Host-side loader producing fixed-shape numpy sample dicts."""

    def __init__(self, cfg: DatasetConfig, split: Optional[str] = None):
        self.cfg = cfg
        self.split = split or cfg.data_split
        base = os.path.join(cfg.dataset_dir, cfg.data_split_dir)
        self.velo_dir = os.path.join(base, "velodyne")
        # real KITTI tracking uses image_02/label_02; the AVOD-era
        # fixture layout (reference avod/tests/datasets/Kitti/tracking)
        # uses the older image_2/label_2 names
        self.image_dir = _first_existing_dir(base, "image_02", "image_2")
        self.calib_dir = os.path.join(base, "calib")
        self.label_dir = _first_existing_dir(base, "label_02", "label_2")
        self.oxts_dir = os.path.join(base, "oxts")
        self.planes_dir = os.path.join(base, "planes")
        self.has_labels = os.path.isdir(self.label_dir)

        split_file = os.path.join(cfg.dataset_dir, self.split + ".txt")
        self.couples = generate_sample_couples(
            split_file, cfg.data_stride, self.split, cfg.video_train_ids)

        self._calib_cache = {}
        self._label_cache = {}
        self._epoch_order = np.arange(len(self.couples))
        self._epoch_pos = 0
        self._rng = np.random.RandomState(0)

    # ------------------------------------------------------------- io

    def __len__(self):
        return len(self.couples)

    def calib(self, video_id: int) -> kitti.FrameCalib:
        if video_id not in self._calib_cache:
            self._calib_cache[video_id] = kitti.read_tracking_calibration(
                self.calib_dir, video_id)
        return self._calib_cache[video_id]

    def labels(self, video_id: int, frame: int) -> kitti.LabelArray:
        key = (video_id, frame)
        if key not in self._label_cache:
            lab = kitti.read_tracking_labels(self.label_dir, video_id, frame)
            self._label_cache[key] = kitti.filter_labels(
                lab, self.cfg.classes)
        return self._label_cache[key]

    def raw_labels(self, video_id: int, frame: int) -> kitti.LabelArray:
        """Unfiltered labels including DontCare regions and neighboring
        classes — the official MOT scorer's GT contract."""
        key = ("raw", video_id, frame)
        if key not in self._label_cache:
            self._label_cache[key] = kitti.read_tracking_labels(
                self.label_dir, video_id, frame, keep_dontcare=True)
        return self._label_cache[key]

    def ground_plane(self, video_id: int, frame: int) -> np.ndarray:
        path = os.path.join(self.planes_dir, f"{video_id:04d}",
                            f"{frame:06d}.txt")
        if os.path.exists(path):
            return kitti.read_ground_plane(
                os.path.join(self.planes_dir, f"{video_id:04d}"),
                f"{frame:06d}")
        return kitti.DEFAULT_GROUND_PLANE.copy()

    def class_index(self, type_str: str) -> int:
        return self.cfg.classes.index(type_str) + 1

    # --------------------------------------------------------- loading

    def _camera_image(self, video_id: int, frame: int):
        """(original (H, W), the RGB image resized to cfg.image_shape as
        uint8) of one frame's camera image."""
        import cv2

        name = os.path.join(f"{video_id:04d}", f"{frame:06d}")
        img = cv2.imread(os.path.join(self.image_dir, name + ".png"))
        img = img[..., ::-1]  # BGR -> RGB
        ih, iw = self.cfg.image_shape
        # keep uint8: the device batch ships 4x fewer bytes (the
        # host->device image copy is the single largest transfer)
        # and the tower casts on device
        return img.shape[:2], cv2.resize(img, (iw, ih))

    def load_couple(self, idx: int, augs: tuple = (),
                    rng: Optional[np.random.RandomState] = None) -> dict:
        cp = self.couples[idx]
        rng = rng or self._rng
        calib = self.calib(cp.video_id)
        p2 = calib.p2.copy()

        # ego motion B -> A
        oxts_a = kitti.read_oxts(self.oxts_dir, cp.video_id, cp.frame_a)
        oxts_b = kitti.read_oxts(self.oxts_dir, cp.video_id, cp.frame_b)
        trans, matrix, dyaw = kitti.ego_motion(oxts_a, oxts_b)

        images, points, valids = [], [], []
        labels = []
        gp = self.ground_plane(cp.video_id, cp.frame_a)
        orig_shape = None
        for i, frame in enumerate((cp.frame_a, cp.frame_b)):
            hw, img = self._camera_image(cp.video_id, frame)
            if orig_shape is None:
                orig_shape = hw
            velo = kitti.read_lidar(
                os.path.join(self.velo_dir, f"{cp.video_id:04d}"),
                f"{frame:06d}")[:, :3]
            if i == 1:
                velo = kitti.transform_points_to_prev_frame(
                    velo, trans, matrix)
            cam = kitti.lidar_to_cam_frame(velo, calib).astype(np.float32)
            fov = kitti.filter_to_image_fov(cam, calib, orig_shape)
            cam = cam[fov]

            if self.has_labels:
                lab = self.labels(cp.video_id, frame)
                if i == 1 and len(lab):
                    lab = kitti.transform_labels_to_prev_frame(
                        lab, calib, trans, matrix, dyaw)
                labels.append(lab)
            images.append(img)
            points.append(cam)

        # ----------------------------------------------------- augment
        if aug.AUG_FLIPPING in augs:
            images = [aug.flip_image(im).copy() for im in images]
            points = [aug.flip_points(p) for p in points]
            labels = [self._flip_labels(l) for l in labels]
            gp = aug.flip_ground_plane(gp)
            p2 = aug.flip_calib_p2(p2, orig_shape)
        if aug.AUG_PCA_JITTER in augs:
            images = [aug.pca_jitter(im, rng) for im in images]

        # --------------------------------------------------------- pad
        pts_pad, pts_valid = zip(*(self._pad_points(p, rng)
                                   for p in points))
        out = {
            "points": np.stack(pts_pad),                    # (2, P, 3)
            "points_valid": np.stack(pts_valid),            # (2, P)
            "image": np.stack(images),                      # (2, H, W, 3)
            "ground_plane": gp.astype(np.float32),          # (4,)
            "p2": p2.astype(np.float32),                    # (3, 4)
            "orig_image_shape": np.array(orig_shape, np.int32),
        }
        if self.has_labels:
            g = self.cfg.max_gt_boxes
            boxes = np.zeros((2, g, 7), np.float32)
            classes = np.zeros((2, g), np.int32)
            valid = np.zeros((2, g), bool)
            tids = np.full((2, g), -1, np.int32)
            for i, lab in enumerate(labels):
                n = min(len(lab), g)
                boxes[i, :n] = lab.box_3d[:n]
                classes[i, :n] = [self.class_index(t)
                                  for t in lab.types[:n]]
                valid[i, :n] = True
                tids[i, :n] = lab.track_ids[:n]
            corr, coexist = self._corr_offsets(boxes, tids, valid)
            out.update({
                "gt_boxes": boxes, "gt_classes": classes,
                "gt_valid": valid, "gt_track_ids": tids,
                "corr_offsets": corr, "corr_coexist": coexist,
            })
        out["sample_name"] = cp.name
        return out

    def _flip_labels(self, lab: kitti.LabelArray) -> kitti.LabelArray:
        out = lab.select(np.ones(len(lab), bool))
        out.box_3d = aug.flip_boxes_3d(out.box_3d)
        return out

    @staticmethod
    def _corr_offsets(boxes, tids, valid):
        """Per frame-0 GT: [dx, dz, dry] to the same track in frame 1
        (reference calculate_corr_offsets:612; zeros when unmatched)."""
        g = boxes.shape[1]
        corr = np.zeros((g, 3), np.float32)
        coexist = np.zeros(g, bool)
        for i in range(g):
            if not valid[0, i]:
                continue
            tid = tids[0, i]
            for j in range(g):
                if valid[1, j] and tids[1, j] == tid:
                    diff = boxes[1, j] - boxes[0, i]
                    corr[i] = [diff[0], diff[2], diff[6]]
                    coexist[i] = True
                    break
        return corr, coexist

    def _pad_points(self, pts: np.ndarray, rng):
        p = self.cfg.max_points
        n = len(pts)
        if n >= p:
            sel = rng.choice(n, p, replace=False) if n > p else np.arange(p)
            return pts[sel].astype(np.float32), np.ones(p, bool)
        out = np.zeros((p, 3), np.float32)
        out[:n] = pts
        valid = np.zeros(p, bool)
        valid[:n] = True
        return out, valid

    # -------------------------------------------------------- batching

    def next_batch(self, batch_size: int, shuffle: bool = True,
                   augment: bool = True) -> dict:
        """Stack `batch_size` couples into a batch dict with a leading
        batch axis (epoch-shuffled like reference next_batch:644)."""
        idxs = []
        for _ in range(batch_size):
            if self._epoch_pos == 0 and shuffle:
                self._rng.shuffle(self._epoch_order)
            idxs.append(self._epoch_order[self._epoch_pos])
            self._epoch_pos = (self._epoch_pos + 1) % len(self.couples)
        samples = []
        for i in idxs:
            augs = self._sample_augs() if augment else ()
            samples.append(self.load_couple(int(i), augs))
        return stack_samples(samples)

    def _sample_augs(self) -> tuple:
        augs = []
        if aug.AUG_FLIPPING in self.cfg.aug_list and self._rng.rand() < 0.5:
            augs.append(aug.AUG_FLIPPING)
        if aug.AUG_PCA_JITTER in self.cfg.aug_list and \
                self._rng.rand() < 0.5:
            augs.append(aug.AUG_PCA_JITTER)
        return tuple(augs)


def stack_samples(samples: List[dict]) -> dict:
    """Stack sample dicts into batched arrays (strings -> lists)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out
