"""Inputs made from the seed: lidar scans with cars in them, images,
the KITTI calibration, ego motion, and the pools of frames and couples
that a traffic mix cycles through.

``velodyne_like_points`` is a copy of ``data/synthetic_scan.py``'s (the
port's copy of bench.py's), ``car_boxes`` and ``car_surface_points``
copies of chip_smoke.py's, rewritten for ``numpy.random.Generator`` so
that any whole-number seed works."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

GROUND_PLANE = (0.0, -1.0, 0.0, 1.65)
KITTI_P2 = ((721.5, 0.0, 609.5, 44.9), (0.0, 721.5, 172.8, 0.2),
            (0.0, 0.0, 1.0, 0.003))
ORIG_IMAGE_SHAPE = (375, 1242)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """An independent generator for (seed, salt...), for any seed >= 0."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed), *map(int, salt)])))


def velodyne_like_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """n points like a 64-beam velodyne's in the camera frame (x right, y
    down, z forward; sensor ~1.65 m above ground): ground returns whose
    range follows the beam elevation, range-decaying clutter, and a
    dozen car-like clusters."""
    beams = 64
    per = n // beams
    elev = np.radians(np.linspace(-24.8, 2.0, beams))[:, None]
    az = rng.uniform(-np.pi / 4.2, np.pi / 4.2, (beams, per))
    sensor_h = 1.65
    with np.errstate(divide="ignore"):
        r_ground = np.where(elev < -0.005, sensor_h / np.tan(-elev), 80.0)
    r = r_ground * rng.uniform(0.92, 1.08, (beams, per))
    hit = rng.random((beams, per)) < 0.33
    r = np.where(hit, rng.uniform(4, 55, (beams, per)), r)
    r = np.clip(r, 2.0, 79.0)
    x = r * np.cos(elev) * np.sin(az)
    z = r * np.cos(elev) * np.cos(az)
    y = r * np.sin(-elev)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    clusters = []
    for _ in range(12):
        cx, cz = rng.uniform(-20, 20), rng.uniform(6, 60)
        m = 220
        clusters.append(np.stack([
            cx + rng.uniform(-2.0, 2.0, m),
            rng.uniform(0.0, 1.6, m),
            cz + rng.uniform(-0.9, 0.9, m)], axis=1))
    pts = np.concatenate([pts, np.concatenate(clusters)])
    pts = pts[rng.permutation(len(pts))[:n]]
    if len(pts) < n:
        pts = np.concatenate(
            [pts, pts[rng.integers(0, len(pts), n - len(pts))]])
    return pts.astype(np.float32)


def car_boxes(rng: np.random.Generator, n: int, ground_y: float
              ) -> np.ndarray:
    """n non-overlapping car boxes (box_3d, camera frame) on a 4-column
    grid in front of the sensor, sizes near the car clusters."""
    cols = 4
    rows = (n + cols - 1) // cols
    gx = np.linspace(-15.0, 15.0, cols)
    gz = np.linspace(12.0, 12.0 + 6.0 * (rows - 1), rows)
    xs, zs = np.meshgrid(gx, gz)
    xs, zs = xs.ravel()[:n], zs.ravel()[:n]
    length = rng.uniform(3.6, 4.2, n)
    width = rng.uniform(1.55, 1.7, n)
    height = rng.uniform(1.45, 1.6, n)
    ry = rng.choice([0.0, -np.pi / 2], n) + rng.uniform(-0.1, 0.1, n)
    return np.stack([xs + rng.uniform(-0.5, 0.5, n), np.full(n, ground_y),
                     zs + rng.uniform(-0.5, 0.5, n), length, width, height,
                     ry], -1).astype(np.float32)


def car_surface_points(rng: np.random.Generator, box: np.ndarray, k: int
                       ) -> np.ndarray:
    """k points on the four sides and the roof of one box_3d."""
    x, y, z, length, width, height, ry = box
    face = rng.integers(0, 5, k)
    u = rng.uniform(-0.5, 0.5, k) * length
    v = rng.uniform(-0.5, 0.5, k) * width
    u = np.where(face == 0, length / 2, np.where(face == 1, -length / 2, u))
    v = np.where(face == 2, width / 2, np.where(face == 3, -width / 2, v))
    up = np.where(face == 4, height, rng.uniform(0.2, 1.0, k) * height)
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([x + u * c + v * s, y - up, z - u * s + v * c],
                    -1).astype(np.float32)


def scan_with_cars(rng: np.random.Generator, boxes: np.ndarray,
                   n_valid: int, capacity: int, car_points: int):
    """(points (capacity, 3), valid (capacity,)): a scan of n_valid
    returns, car_points of which lie on each box's surface, the rest of
    the capacity zero padding with valid False."""
    pts = velodyne_like_points(rng, n_valid)
    k = min(car_points, n_valid // max(len(boxes), 1))
    idx = rng.permutation(n_valid)[:k * len(boxes)]
    if len(boxes):
        pts[idx] = np.concatenate([car_surface_points(rng, b, k)
                                   for b in boxes])
    points = np.zeros((capacity, 3), np.float32)
    points[:n_valid] = pts
    valid = np.zeros(capacity, bool)
    valid[:n_valid] = True
    return points, valid


def ego_motion(yaw_deg: float, translate_xz: Sequence[float]):
    """(a2, b2): the rotation by yaw_deg and the translation that map
    the new keyframe's camera (x, z) into the previous keyframe's."""
    th = np.radians(yaw_deg)
    a2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                  np.float32)
    return a2, np.asarray(translate_xz, np.float32)


def car_counts(seed: int, mix: Dict, salt: int) -> List[int]:
    """The cars of each pool item: lo, lo + 1, ..., hi in turn over the
    pool (mix["cars"] = [lo, hi]), in an order drawn from the seed, so
    that every seed has the same set of sizes."""
    lo, hi = mix["cars"]
    counts = [lo + i % (hi - lo + 1) for i in range(mix["pool"])]
    return [counts[i] for i in rng_for(seed, salt).permutation(len(counts))]


def frame_pool(seed: int, mix: Dict, capacity: int, image_hw) -> List[Dict]:
    """mix["pool"] frames, each host arrays with a leading batch axis of
    1 in the keys push_keyframe takes: a scan of mix["valid_points"]
    returns with ``car_counts`` cars, and a seeded image. The sizes and
    counts do not depend on the seed."""
    out = []
    for i, n_cars in enumerate(car_counts(seed, mix, 1)):
        rng = rng_for(seed, 1, i)
        boxes = car_boxes(rng, n_cars, GROUND_PLANE[3])
        points, valid = scan_with_cars(rng, boxes, mix["valid_points"],
                                       capacity, mix["car_points"])
        image = rng.uniform(0, 255, (1, *image_hw, 3)).astype(np.float32)
        out.append({
            "points": points[None], "points_valid": valid[None],
            "image": image,
            "ground_plane": np.array([GROUND_PLANE], np.float32),
            "p2": np.array([KITTI_P2], np.float32),
            "orig_image_shape": np.array([ORIG_IMAGE_SHAPE], np.int32)})
    return out


def couple_pool(seed: int, mix: Dict, capacity: int, image_hw,
                max_gt: int) -> List[Dict]:
    """mix["pool"] training couples (B = 1, F = 2) in the dataset's keys:
    two scans of one scene of ``car_counts`` cars (the second frame's
    returns jittered by 5 cm), seeded images, the GT boxes in both
    frames, seeded correlation offsets, every car in both frames."""
    out = []
    for i, n_gt in enumerate(car_counts(seed, mix, 2)):
        rng = rng_for(seed, 2, i)
        boxes = car_boxes(rng, n_gt, GROUND_PLANE[3])
        pts, valid = zip(*(scan_with_cars(rng, boxes, mix["valid_points"],
                                          capacity, mix["car_points"])
                           for _ in range(2)))
        pts = np.stack(pts)
        pts[1, valid[1]] += rng.normal(0, 0.05, (int(valid[1].sum()), 3)
                                       ).astype(np.float32)
        gt = np.zeros((1, 2, max_gt, 7), np.float32)
        gt[0, :, :n_gt] = boxes
        gv = np.zeros((1, 2, max_gt), bool)
        gv[0, :, :n_gt] = True
        out.append({
            "points": pts[None], "points_valid": np.stack(valid)[None],
            "image": rng.uniform(0, 255, (1, 2, *image_hw, 3)
                                 ).astype(np.float32),
            "ground_plane": np.array([GROUND_PLANE], np.float32),
            "p2": np.array([KITTI_P2], np.float32),
            "orig_image_shape": np.array([ORIG_IMAGE_SHAPE], np.int32),
            "gt_boxes": gt, "gt_classes": gv.astype(np.int32),
            "gt_valid": gv,
            "gt_track_ids": np.where(gv, np.arange(max_gt),
                                     -1).astype(np.int32),
            "corr_offsets": np.where(gv[0, :1, :, None], rng.uniform(
                -0.5, 0.5, (1, max_gt, 3)), 0.0).astype(np.float32),
            "corr_coexist": gv[:, 0].copy()})
    return out


class PoolDataset:
    """The Trainer's dataset: ``next_batch`` hands out the pool's couples
    in turn and records which one each call served."""

    def __init__(self, pool: List[Dict]):
        self.pool = pool
        self.served: List[int] = []

    def next_batch(self, batch_size: int, augment: bool = True) -> Dict:
        idx = [(len(self.served) + j) % len(self.pool)
               for j in range(batch_size)]
        self.served.extend(idx)
        return self.batch(self.pool, idx)

    @staticmethod
    def batch(pool: List[Dict], idx: List[int]) -> Dict:
        """The couples ``idx`` of ``pool`` as one batch."""
        parts = [pool[i] for i in idx]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
