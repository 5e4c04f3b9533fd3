"""Synthetic inputs for timing the port: a velodyne-like scan and one
paired-frame batch (the port's copy of bench.py's
``velodyne_like_points``, ``make_batch``, ``TAU`` and ``BASELINE_FPS``,
so that bench_torch.py and chip_smoke.py feed the port what bench.py
feeds the JAX model, from the same seed)."""
from __future__ import annotations

import numpy as np

TAU = 3
BASELINE_FPS = 11.4  # reference DODT tau=3 S+T+M (BASELINE.md)


def velodyne_like_points(rng, n):
    """Synthetic scan mimicking a 64-beam velodyne's density profile in
    the camera frame (x right, y down, z forward; sensor ~1.65 m above
    ground): ground returns whose range follows the beam elevation,
    range-decaying clutter, and a handful of car-like clusters. Real
    scans are highly non-uniform and the dense-lattice occupancy
    filter's work depends on that distribution, so the bench should
    not use uniform points."""
    beams = 64
    per = n // beams
    elev = np.radians(np.linspace(-24.8, 2.0, beams))[:, None]
    az = rng.uniform(-np.pi / 4.2, np.pi / 4.2, (beams, per))
    sensor_h = 1.65
    # ground-return range per beam; upward beams mostly see far clutter
    with np.errstate(divide="ignore"):
        r_ground = np.where(elev < -0.005, sensor_h / np.tan(-elev), 80.0)
    r = r_ground * rng.uniform(0.92, 1.08, (beams, per))
    # a third of returns hit vertical structure at a nearer range
    hit = rng.rand(beams, per) < 0.33
    r = np.where(hit, rng.uniform(4, 55, (beams, per)), r)
    r = np.clip(r, 2.0, 79.0)
    x = r * np.cos(elev) * np.sin(az)
    z = r * np.cos(elev) * np.cos(az)
    y = r * np.sin(-elev)  # camera y is down; negative elevation -> +y
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    # car-like clusters
    clusters = []
    for _ in range(12):
        cx, cz = rng.uniform(-20, 20), rng.uniform(6, 60)
        m = 220
        clusters.append(np.stack([
            cx + rng.uniform(-2.0, 2.0, m),
            rng.uniform(0.0, 1.6, m),
            cz + rng.uniform(-0.9, 0.9, m)], axis=1))
    cl = np.concatenate(clusters)
    # mix clusters INTO the scan, then subsample to exactly n (beams
    # alone already total ~n, so appending only a remainder would drop
    # the clusters entirely)
    pts = np.concatenate([pts, cl])
    idx = rng.permutation(len(pts))[:n]
    pts = pts[idx]
    if len(pts) < n:
        pts = np.concatenate(
            [pts, pts[rng.randint(0, len(pts), n - len(pts))]])
    return pts.astype(np.float32)


def make_batch(cfg, rng):
    """One couple (B = 1, F = 2) of host arrays at the config's point
    capacity and image shape: the scan and a jittered copy of it,
    random images, a flat ground plane and KITTI's P2."""
    p = cfg.dataset.max_points
    h, w = cfg.dataset.image_shape
    pts = velodyne_like_points(rng, p)
    batch = {
        "points": np.stack([pts, pts + rng.normal(0, 0.05, pts.shape)
                            .astype(np.float32)])[None],
        "points_valid": np.ones((1, 2, p), bool),
        "image": rng.uniform(0, 255, (1, 2, h, w, 3)).astype(np.float32),
        "ground_plane": np.array([[0.0, -1.0, 0.0, 1.65]], np.float32),
        "p2": np.array([[[721.5, 0, 609.5, 44.9],
                         [0, 721.5, 172.8, 0.2],
                         [0, 0, 1.0, 0.003]]], np.float32),
        "orig_image_shape": np.array([[375, 1242]], np.int32),
    }
    return batch
