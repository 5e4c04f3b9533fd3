"""KITTI data readers (host-side, numpy): labels, calibration, lidar,
planes, ego-motion.

Parity targets in the reference (semantics, not code):
  wavedata obj_utils.read_labels:67 / tracking_utils.read_labels:45,
  calib_utils.read_calibration:95 / read_tracking_calibration:155,
  calib_utils.read_lidar:441 / lidar_to_cam_frame:484,
  obj_utils.get_road_plane:271, kitti_tracking_utils.Oxts:129.

Labels are held as a vectorized `LabelArray` (struct of arrays) rather
than per-object classes — everything downstream is batched numpy/JAX.

The port's copy of dodt_tpu/data/kitti.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------- labels

@dataclass
class LabelArray:
    """Struct-of-arrays KITTI labels. box_3d columns: [x,y,z,l,w,h,ry]."""
    types: np.ndarray          # (N,) str objects
    box_3d: np.ndarray         # (N, 7) float32
    bbox_2d: np.ndarray        # (N, 4) float32 [x1, y1, x2, y2]
    truncation: np.ndarray     # (N,) float32
    occlusion: np.ndarray      # (N,) float32
    alpha: np.ndarray          # (N,) float32
    scores: np.ndarray         # (N,) float32
    track_ids: np.ndarray      # (N,) int32 (-1 when not a tracking label)
    frames: np.ndarray = field(default=None)  # (N,) int32 tracking frame

    def __len__(self):
        return len(self.box_3d)

    def select(self, mask) -> "LabelArray":
        mask = np.asarray(mask)
        return LabelArray(
            types=self.types[mask], box_3d=self.box_3d[mask],
            bbox_2d=self.bbox_2d[mask], truncation=self.truncation[mask],
            occlusion=self.occlusion[mask], alpha=self.alpha[mask],
            scores=self.scores[mask], track_ids=self.track_ids[mask],
            frames=None if self.frames is None else self.frames[mask])

    @staticmethod
    def empty() -> "LabelArray":
        return LabelArray(
            types=np.array([], object), box_3d=np.zeros((0, 7), np.float32),
            bbox_2d=np.zeros((0, 4), np.float32),
            truncation=np.zeros(0, np.float32),
            occlusion=np.zeros(0, np.float32),
            alpha=np.zeros(0, np.float32), scores=np.zeros(0, np.float32),
            track_ids=np.zeros(0, np.int32), frames=np.zeros(0, np.int32))


def _parse_label_fields(fields, tracking: bool) -> dict:
    """One KITTI label line -> dict of parsed values.

    Detection: type trunc occ alpha bbox(4) h w l x y z ry [score]
    Tracking:  frame track_id type trunc occ alpha bbox(4) h w l x y z ry
    """
    off = 2 if tracking else 0
    h, w, l = (float(fields[off + 8]), float(fields[off + 9]),
               float(fields[off + 10]))
    x, y, z = (float(fields[off + 11]), float(fields[off + 12]),
               float(fields[off + 13]))
    ry = float(fields[off + 14])
    score = float(fields[off + 15]) if len(fields) > off + 15 else 0.0
    return dict(
        frame=int(fields[0]) if tracking else -1,
        track_id=int(fields[1]) if tracking else -1,
        type=fields[off + 0],
        truncation=float(fields[off + 1]),
        occlusion=float(fields[off + 2]),
        alpha=float(fields[off + 3]),
        bbox=[float(fields[off + 4]), float(fields[off + 5]),
              float(fields[off + 6]), float(fields[off + 7])],
        box_3d=[x, y, z, l, w, h, ry],
        score=score)


def _labels_from_rows(rows) -> LabelArray:
    if not rows:
        return LabelArray.empty()
    return LabelArray(
        types=np.array([r["type"] for r in rows], object),
        box_3d=np.array([r["box_3d"] for r in rows], np.float32),
        bbox_2d=np.array([r["bbox"] for r in rows], np.float32),
        truncation=np.array([r["truncation"] for r in rows], np.float32),
        occlusion=np.array([r["occlusion"] for r in rows], np.float32),
        alpha=np.array([r["alpha"] for r in rows], np.float32),
        scores=np.array([r["score"] for r in rows], np.float32),
        track_ids=np.array([r["track_id"] for r in rows], np.int32),
        frames=np.array([r["frame"] for r in rows], np.int32))


def read_labels(label_dir: str, sample_name: str,
                keep_dontcare: bool = False) -> LabelArray:
    """Read a detection label file `<label_dir>/<sample_name>.txt`.
    DontCare regions are dropped unless `keep_dontcare` (the official
    scorers need them for detection absorption)."""
    path = os.path.join(label_dir, sample_name + ".txt")
    rows = []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if len(fields) < 15 or \
                    (fields[0] == "DontCare" and not keep_dontcare):
                continue
            rows.append(_parse_label_fields(fields, tracking=False))
    return _labels_from_rows(rows)


def read_tracking_labels(label_dir: str, video_id: int,
                         frame: int | None = None,
                         keep_dontcare: bool = False) -> LabelArray:
    """Read tracking labels for a video (label_02 format), optionally
    filtered to one frame."""
    path = os.path.join(label_dir, f"{video_id:04d}.txt")
    rows = []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if len(fields) < 17 or \
                    (fields[2] == "DontCare" and not keep_dontcare):
                continue
            row = _parse_label_fields(fields, tracking=True)
            if frame is None or row["frame"] == frame:
                rows.append(row)
    return _labels_from_rows(rows)


def filter_labels(labels: LabelArray, classes, difficulty: int | None = None,
                  max_occlusion: float | None = None) -> LabelArray:
    """Class/difficulty/occlusion filter (reference
    kitti_utils.filter_labels:319; HEIGHT/OCCLUSION/TRUNCATION tables)."""
    height_tbl = (40, 25, 25)
    occ_tbl = (0, 1, 2)
    trunc_tbl = (0.15, 0.3, 0.5)
    mask = np.array([t in classes for t in labels.types], bool)
    if difficulty is not None:
        bbox_h = labels.bbox_2d[:, 3] - labels.bbox_2d[:, 1]
        mask &= ((labels.occlusion <= occ_tbl[difficulty]) &
                 (labels.truncation <= trunc_tbl[difficulty]) &
                 (bbox_h >= height_tbl[difficulty]))
    if max_occlusion is not None:
        mask &= labels.occlusion <= max_occlusion
    return labels.select(mask)


# ---------------------------------------------------------------- calib

@dataclass
class FrameCalib:
    p2: np.ndarray               # (3, 4)
    r0: np.ndarray               # (3, 3) rect rotation
    velo_to_cam: np.ndarray      # (3, 4)

    def velo_to_rect(self, pts_velo: np.ndarray) -> np.ndarray:
        """(N, 3) velodyne -> rectified camera frame."""
        ones = np.ones((len(pts_velo), 1), pts_velo.dtype)
        cam = (self.velo_to_cam @ np.hstack([pts_velo, ones]).T).T
        return (self.r0 @ cam.T).T

    def rect_to_velo(self, pts_rect: np.ndarray) -> np.ndarray:
        cam = (np.linalg.inv(self.r0) @ pts_rect.T).T
        rot = self.velo_to_cam[:, :3]
        t = self.velo_to_cam[:, 3]
        return (np.linalg.inv(rot) @ (cam - t).T).T

    def project_rect_to_image(self, pts_rect: np.ndarray) -> np.ndarray:
        ones = np.ones((len(pts_rect), 1), pts_rect.dtype)
        uvw = (self.p2 @ np.hstack([pts_rect, ones]).T).T
        return uvw[:, :2] / uvw[:, 2:3]


def _parse_calib_lines(lines: dict) -> FrameCalib:
    p2 = np.array(lines["P2"], np.float32).reshape(3, 4)
    r0 = np.array(lines.get("R0_rect", lines.get("R_rect")),
                  np.float32).reshape(3, 3)
    vtc = np.array(lines.get("Tr_velo_to_cam", lines.get("Tr_velo_cam")),
                   np.float32).reshape(3, 4)
    return FrameCalib(p2=p2, r0=r0, velo_to_cam=vtc)


def read_calibration(calib_dir: str, sample_name: str) -> FrameCalib:
    """Detection-style per-frame calib file."""
    return _read_calib_file(os.path.join(calib_dir, sample_name + ".txt"))


def read_tracking_calibration(calib_dir: str, video_id: int) -> FrameCalib:
    """Tracking-style per-video calib file."""
    return _read_calib_file(os.path.join(calib_dir, f"{video_id:04d}.txt"))


def _read_calib_file(path: str) -> FrameCalib:
    lines = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                key, vals = line.split(":", 1)
            else:
                parts = line.split()
                if not parts:
                    continue
                key, vals = parts[0], " ".join(parts[1:])
            vals = vals.split()
            if vals:
                lines[key.strip()] = [float(v) for v in vals]
    return _parse_calib_lines(lines)


# ---------------------------------------------------------------- lidar

def read_lidar(velo_dir: str, sample_name: str) -> np.ndarray:
    """Read a velodyne .bin -> (N, 4) [x, y, z, intensity] (velo frame)."""
    path = os.path.join(velo_dir, sample_name + ".bin")
    return np.fromfile(path, np.float32).reshape(-1, 4)


def lidar_to_cam_frame(pts_velo_xyz: np.ndarray, calib: FrameCalib
                       ) -> np.ndarray:
    """(N, 3) velo -> rectified cam0 frame."""
    return calib.velo_to_rect(pts_velo_xyz)


def filter_to_image_fov(pts_cam: np.ndarray, calib: FrameCalib,
                        image_shape) -> np.ndarray:
    """Boolean mask of points that project inside the image and are in
    front of the camera (reference get_lidar_in_camera_view:117)."""
    uv = calib.project_rect_to_image(pts_cam)
    h, w = image_shape[0], image_shape[1]
    return ((uv[:, 0] >= 0) & (uv[:, 0] <= w - 1) &
            (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1) & (pts_cam[:, 2] > 0))


# ---------------------------------------------------------------- planes

def read_ground_plane(planes_dir: str, sample_name: str) -> np.ndarray:
    """Read a plane file; normalizes so the normal's y is negative
    (reference obj_utils.get_road_plane:271).

    Sanity check: in the y-down camera frame a road plane must sit
    BELOW the camera, i.e. d > 0 after the y<0 normalization. KITTI
    tracking planes files are stored in an inconsistent convention
    that fails this (the reference hardcodes [0,-1,0,1.65] for
    tracking for exactly this reason, obj_utils.get_road_plane:301);
    fall back to the default plane when the file is unusable."""
    path = os.path.join(planes_dir, sample_name + ".txt")
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    plane = np.array([float(v) for v in lines[-1].split()], np.float32)
    norm = np.linalg.norm(plane[:3])
    plane = plane / norm
    if plane[1] > 0:
        plane = -plane
    if plane[3] <= 0.2:  # ground at/above the camera: bogus file
        return DEFAULT_GROUND_PLANE.copy()
    return plane


DEFAULT_GROUND_PLANE = np.array([0.0, -1.0, 0.0, 1.65], np.float32)


# ---------------------------------------------------------------- oxts

@dataclass
class Oxts:
    """GPS/IMU pose record (reference kitti_tracking_utils.Oxts:129)."""
    latitude: float
    longitude: float
    altitude: float
    roll: float
    pitch: float
    yaw: float

    @staticmethod
    def from_line(line: str) -> "Oxts":
        vals = [float(v) for v in line.split()]
        return Oxts(latitude=vals[0], longitude=vals[1], altitude=vals[2],
                    roll=vals[3], pitch=vals[4], yaw=vals[5])


def read_oxts(oxts_dir: str, video_id: int, frame: int) -> Oxts:
    path = os.path.join(oxts_dir, f"{video_id:04d}.txt")
    with open(path) as f:
        lines = f.read().splitlines()
    return Oxts.from_line(lines[frame])


def _haversine(o1: Oxts, o2: Oxts) -> float:
    lat1, lon1 = np.deg2rad(o1.latitude), np.deg2rad(o1.longitude)
    lat2, lon2 = np.deg2rad(o2.latitude), np.deg2rad(o2.longitude)
    r = 6378137.0
    a = lat2 - lat1
    b = lon2 - lon1
    return abs(2 * r * np.arcsin(np.sqrt(
        np.sin(a / 2) ** 2 + np.cos(lat1) * np.cos(lat2)
        * np.sin(b / 2) ** 2)))


def ego_motion(cur: Oxts, nxt: Oxts):
    """Translation + rotation to express the NEXT frame's velo points in
    the CURRENT frame's velo coordinates (reference
    coordinate_transform, kitti_tracking_dataset.py:303-322):
      p_cur = (p_next + trans) @ matrix

    Returns (trans (3,), matrix (3, 3), delta_yaw).
    """
    d = _haversine(cur, nxt)
    dyaw = cur.yaw - nxt.yaw
    dpitch = cur.pitch - nxt.pitch
    droll = cur.roll - nxt.roll
    trans = np.array([d * np.cos(dyaw), d * np.sin(dyaw),
                      d * np.sin(dpitch)], np.float64)

    def rot_x(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def rot_like_z(t):  # reference Oxts.rotz layout
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rot_like_y(t):  # reference Oxts.roty layout
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    matrix = rot_like_z(dpitch) @ rot_x(droll) @ rot_like_y(dyaw)
    return trans.astype(np.float64), matrix, dyaw


def transform_points_to_prev_frame(pts_velo: np.ndarray, trans, matrix
                                   ) -> np.ndarray:
    """Apply the ego-motion transform to velo-frame xyz points."""
    return (pts_velo + trans) @ matrix


def ego_bev_affine(calib: "FrameCalib", trans, matrix):
    """2D affine mapping camera-rect (x, z) of the NEXT frame to the
    CURRENT frame, for BEV feature warping (ops/warp.py):
      [x_cur, z_cur] = a2 @ [x_next, z_next] + b2.

    Extracted numerically from the composite rect -> velo -> ego
    transform -> rect (avoids re-deriving the conjugation by the calib
    rotation)."""
    def f(p_cam):
        v = calib.rect_to_velo(p_cam[None])
        v = transform_points_to_prev_frame(v, trans, matrix)
        return calib.velo_to_rect(v)[0]

    o = f(np.zeros(3))
    ax = f(np.array([1.0, 0.0, 0.0])) - o
    az = f(np.array([0.0, 0.0, 1.0])) - o
    a2 = np.array([[ax[0], az[0]], [ax[2], az[2]]], np.float32)
    b2 = np.array([o[0], o[2]], np.float32)
    return a2, b2


def is_identity_ego(trans, matrix, delta_yaw,
                    tol: float = 1e-9) -> bool:
    """True when the ego transform is numerically a no-op (stationary
    platform). Callers skip the corner round-trip entirely so that
    zero-ego outputs stay bit-identical to the untransformed path."""
    return (float(np.abs(trans).max()) < tol and
            abs(float(delta_yaw)) < tol and
            float(np.abs(matrix - np.eye(3)).max()) < tol)


def transform_boxes_3d(boxes_3d: np.ndarray, calib: FrameCalib,
                       trans, matrix, delta_yaw,
                       inverse: bool = False) -> np.ndarray:
    """Move (N, 7) box_3d arrays between ego frames via 8-corner
    rotation in velo space (reference label_transform:338-371 /
    label_inverse_transform + recovery_t:372-398).

    Forward (`inverse=False`): frame-B own coords -> frame-A coords,
    with (trans, matrix, delta_yaw) = ego_motion(oxts_A, oxts_B).
    Inverse: frame-A coords -> frame-B own coords (the reference's
    `recovery_coordinate` step, evaluator_utils.py:401).
    Pure numpy — the host data path must never dispatch JAX ops."""
    from dodt_tpu_torch.utils.np_iou import box_3d_corners

    boxes_3d = np.asarray(boxes_3d, np.float64)
    if len(boxes_3d) == 0 or is_identity_ego(trans, matrix, delta_yaw):
        return boxes_3d.copy()
    out = boxes_3d.copy()
    inv = np.linalg.inv(matrix) if inverse else None
    for i in range(len(out)):
        c = box_3d_corners(boxes_3d[i])          # (8, 3) cam frame
        c_velo = calib.rect_to_velo(c)
        if inverse:
            c_velo = c_velo @ inv - trans
        else:
            c_velo = (c_velo + trans) @ matrix
        c_cam = calib.velo_to_rect(c_velo)
        new_t = c_cam.mean(axis=0)
        new_t[1] += out[i, 5] / 2.0              # centroid -> bottom face
        out[i, 0:3] = new_t
        out[i, 6] += -delta_yaw if inverse else delta_yaw
    return out


def transform_labels_to_prev_frame(labels: LabelArray, calib: FrameCalib,
                                   trans, matrix, delta_yaw) -> LabelArray:
    """Move frame-B labels into frame-A coordinates (reference
    label_transform:338-371)."""
    if len(labels) == 0:
        return labels
    out = labels.select(np.ones(len(labels), bool))
    out.box_3d = transform_boxes_3d(
        labels.box_3d, calib, trans, matrix, delta_yaw).astype(
        labels.box_3d.dtype)
    return out


def inverse_transform_labels(labels: LabelArray, calib: FrameCalib,
                             trans, matrix, delta_yaw) -> LabelArray:
    """Inverse of transform_labels_to_prev_frame (reference
    label_inverse_transform / recovery_t:372-398)."""
    if len(labels) == 0:
        return labels
    out = labels.select(np.ones(len(labels), bool))
    out.box_3d = transform_boxes_3d(
        labels.box_3d, calib, trans, matrix, delta_yaw,
        inverse=True).astype(labels.box_3d.dtype)
    return out
