"""BEV-border offset targets for objects leaving the detection area (the
port's copy of dodt_tpu/ops/label_offset.py, host numpy code).

Parity target: reference kitti_dataset/label_offset.py (getOffsets:53)
— for an object at position p moving with velocity v inside the BEV
area, compute the offset along v to the point where the ray p + t*v
exits the area rectangle. Used to build motion GT for objects whose
matched next-frame box falls outside the area extents.
"""
from __future__ import annotations

import numpy as np


def ray_to_border(p, v, bev_extents) -> np.ndarray:
    """Intersection of the ray p + t v (t >= 0) with the BEV rectangle
    border. p, v: (2,) [x, z]; bev_extents [[x_min, x_max],
    [z_min, z_max]]. Returns the border point (p itself if v == 0)."""
    p = np.asarray(p, np.float64)
    v = np.asarray(v, np.float64)
    (x_min, x_max), (z_min, z_max) = bev_extents
    if np.allclose(v, 0):
        return p.copy()
    ts = []
    if v[0] > 0:
        ts.append((x_max - p[0]) / v[0])
    elif v[0] < 0:
        ts.append((x_min - p[0]) / v[0])
    if v[1] > 0:
        ts.append((z_max - p[1]) / v[1])
    elif v[1] < 0:
        ts.append((z_min - p[1]) / v[1])
    t = min(t for t in ts if t >= 0) if any(t >= 0 for t in ts) else 0.0
    return p + t * v


def border_offset(box_3d_a: np.ndarray, box_3d_b: np.ndarray,
                  bev_extents) -> np.ndarray:
    """Offset [dx, dz] from box A toward box B, clipped so the target
    stays inside the BEV area (for B outside the extents the offset
    points to the border exit along the motion ray)."""
    pa = np.array([box_3d_a[0], box_3d_a[2]], np.float64)
    pb = np.array([box_3d_b[0], box_3d_b[2]], np.float64)
    (x_min, x_max), (z_min, z_max) = bev_extents
    inside = (x_min <= pb[0] <= x_max) and (z_min <= pb[1] <= z_max)
    if inside:
        return pb - pa
    border = ray_to_border(pa, pb - pa, bev_extents)
    return border - pa
