"""Kalman-filter tracking pipeline.

Parity target: reference utils/kalman_tracker.Tracker:9 (8-state
constant-velocity KF over [x, x', y, y', z, z', ry, ry']) and
tracking/kf_tracking.kf_pipeline:337 (Hungarian assignment on
ego-motion-transformed 3D IoU, direction correction, birth/death
bookkeeping).

The port's copy of dodt_tpu/tracking/kalman.py.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from dodt_tpu_torch.utils.np_iou import three_d_iou_matrix


class KalmanBoxTracker:
    """Constant-velocity KF on [x, vx, y, vy, z, vz, ry, vry]."""

    def __init__(self, box_3d: np.ndarray, track_id: int):
        self.dt = 1.0
        dt = self.dt
        # state transition
        self.F = np.eye(8)
        for i in range(0, 8, 2):
            self.F[i, i + 1] = dt
        self.H = np.zeros((4, 8))
        for i in range(4):
            self.H[i, 2 * i] = 1.0
        self.P = np.eye(8) * 10.0
        self.P[1::2, 1::2] *= 100.0   # high uncertainty on velocities
        self.Q = np.eye(8) * 0.01
        self.R = np.eye(4) * 0.1
        self.x = np.zeros(8)
        self.x[0::2] = [box_3d[0], box_3d[1], box_3d[2], box_3d[6]]
        self.dims = np.array(box_3d[3:6])
        self.track_id = track_id
        self.hits = 1
        self.misses = 0
        self.score = 0.0

    def predict(self) -> np.ndarray:
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.box()

    def update(self, box_3d: np.ndarray):
        z = np.array([box_3d[0], box_3d[1], box_3d[2], box_3d[6]])
        # direction correction (kf_tracking.py:263): flip measured ry by
        # pi when it disagrees with the track's heading by > pi/2
        dry = z[3] - self.x[6]
        while dry > np.pi:
            dry -= 2 * np.pi
        while dry < -np.pi:
            dry += 2 * np.pi
        if abs(dry) > np.pi / 2:
            z[3] = z[3] - np.pi if dry > 0 else z[3] + np.pi
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(8) - k @ self.H) @ self.P
        self.dims = 0.7 * self.dims + 0.3 * np.array(box_3d[3:6])
        self.hits += 1
        self.misses = 0

    def box(self) -> np.ndarray:
        return np.array([self.x[0], self.x[2], self.x[4], *self.dims,
                         self.x[6]])

    def apply_ego(self, boxes_fn):
        """Re-express the filter state in a new coordinate frame.

        `boxes_fn`: (N, 7) box_3d -> (N, 7) rigid transform (previous
        frame's coordinates -> current frame's). Position and heading
        map through the box transform directly; planar velocity maps
        exactly by transforming a velocity-displaced probe center (no
        convention-sensitive angle math)."""
        b = self.box()
        probe = b.copy()
        probe[0] += self.x[1] * self.dt
        probe[2] += self.x[5] * self.dt
        nb, nprobe = boxes_fn(np.stack([b, probe]))
        self.x[0], self.x[2], self.x[4] = nb[0], nb[1], nb[2]
        self.x[6] = nb[6]
        self.x[1] = (nprobe[0] - nb[0]) / self.dt
        self.x[5] = (nprobe[2] - nb[2]) / self.dt


def assign_detections_to_trackers(trackers: List[np.ndarray],
                                  detections: List[np.ndarray],
                                  iou_threshold: float = 0.01):
    """Hungarian assignment on 3D IoU (kf_tracking.py:281)."""
    if not trackers or not detections:
        return [], list(range(len(trackers))), list(range(len(detections)))
    iou = three_d_iou_matrix(np.stack(trackers), np.stack(detections))
    rows, cols = linear_sum_assignment(-iou)
    matches, un_t, un_d = [], [], []
    matched_t, matched_d = set(), set()
    for r, c in zip(rows, cols):
        if iou[r, c] >= iou_threshold:
            matches.append((r, c))
            matched_t.add(r)
            matched_d.add(c)
    un_t = [t for t in range(len(trackers)) if t not in matched_t]
    un_d = [d for d in range(len(detections)) if d not in matched_d]
    return matches, un_t, un_d


def kf_pipeline(dets_per_frame: List[List[Dict]],
                iou_threshold: float = 0.01,
                max_misses: int = 2,
                min_hits: int = 2,
                ego_fn=None) -> List[Dict]:
    """Frame-by-frame KF predict/assign/update (kf_tracking.py:337).

    `ego_fn(i_prev, i_cur, boxes (N, 7)) -> (N, 7)`: optional ego-motion
    compensation expressing frame i_prev boxes in frame i_cur's own
    coordinates (positional indices into `dets_per_frame`). Every
    tracker state is re-expressed in the current frame before
    prediction, so assignment IoU is ego-compensated like the
    reference's (kf_tracking.assign_detections_to_trackers:281-305 via
    cal_transformed_ious) and the constant-velocity model tracks
    object motion, not object+platform motion.

    Returns finished tracks in the iou_tracker trajectory format.
    """
    trackers: List[KalmanBoxTracker] = []
    next_id = 0
    books: Dict[int, Dict] = {}

    for frame, dets in enumerate(dets_per_frame):
        if ego_fn is not None and frame > 0 and trackers:
            fn = lambda b: ego_fn(frame - 1, frame, b)  # noqa: E731
            for t in trackers:
                t.apply_ego(fn)
        predicted = [t.predict() for t in trackers]
        det_boxes = [np.asarray(d["box_3d"], np.float64) for d in dets]
        matches, un_t, un_d = assign_detections_to_trackers(
            predicted, det_boxes, iou_threshold)

        for t_idx, d_idx in matches:
            trk = trackers[t_idx]
            trk.update(det_boxes[d_idx])
            trk.score = max(trk.score, dets[d_idx]["score"])
            books[trk.track_id]["trajectory"].append(dets[d_idx])
            books[trk.track_id]["frames"].append(frame)
            books[trk.track_id]["max_score"] = trk.score

        for t_idx in un_t:
            trackers[t_idx].misses += 1

        for d_idx in un_d:
            trk = KalmanBoxTracker(det_boxes[d_idx], next_id)
            trk.score = dets[d_idx]["score"]
            trackers.append(trk)
            books[next_id] = {"trajectory": [dets[d_idx]],
                              "frames": [frame],
                              "max_score": trk.score,
                              "start_frame": frame}
            next_id += 1

        trackers = [t for t in trackers if t.misses <= max_misses]

    return [b for b in books.values() if len(b["trajectory"]) >= min_hits]
