"""Numpy rotated BEV IoU for host-side evaluation (the port's copy of
``rotated_iou_matrix`` and the helpers it calls from
dodt_tpu/utils/np_iou.py): analytic convex-quad intersection,
Sutherland-Hodgman clipping batched over box pairs.
"""
from __future__ import annotations

import numpy as np


def _rect_corners_batch(boxes):
    """(M, 5) [x, z, l, w, ry] -> (M, 4, 2) corners."""
    x, z, l, w, ry = (boxes[:, i] for i in range(5))
    c, s = np.cos(ry), np.sin(ry)
    xc = np.array([1.0, 1.0, -1.0, -1.0]) / 2.0
    zc = np.array([1.0, -1.0, -1.0, 1.0]) / 2.0
    lx = l[:, None] * xc
    wz = w[:, None] * zc
    return np.stack([c[:, None] * lx + s[:, None] * wz + x[:, None],
                     -s[:, None] * lx + c[:, None] * wz + z[:, None]],
                    axis=2)


def _clip_polys_batch(V, n, a, b):
    """Sutherland-Hodgman step for a BATCH of polygons against one
    half-plane each (left of a->b). V (M, K, 2) vertex buffers, n (M,)
    live vertex counts, a/b (M, 2). Returns (V', n') with K' = 2K slots
    (each input vertex can emit itself + one intersection)."""
    m, k, _ = V.shape
    idx = np.arange(k)
    live = idx[None, :] < n[:, None]                        # (M, K)
    nxt_i = idx[None, :] + 1
    nxt_i = np.where(nxt_i < n[:, None], nxt_i, 0)
    nxt = np.take_along_axis(V, nxt_i[:, :, None], axis=1)  # wraps
    e = b - a                                               # (M, 2)
    d_cur = (e[:, None, 0] * (V[:, :, 1] - a[:, None, 1]) -
             e[:, None, 1] * (V[:, :, 0] - a[:, None, 0]))
    d_nxt = (e[:, None, 0] * (nxt[:, :, 1] - a[:, None, 1]) -
             e[:, None, 1] * (nxt[:, :, 0] - a[:, None, 0]))
    keep = (d_cur >= 0) & live
    cross = (((d_cur > 0) != (d_nxt > 0)) &
             ((d_cur < 0) | (d_nxt < 0)) & live)
    denom = d_cur - d_nxt
    t = d_cur / np.where(denom == 0.0, 1.0, denom)
    inter = V + t[:, :, None] * (nxt - V)
    # interleave: slot 2i = kept vertex i, slot 2i+1 = its intersection
    out = np.empty((m, 2 * k, 2))
    out[:, 0::2] = V
    out[:, 1::2] = inter
    mask = np.empty((m, 2 * k), dtype=bool)
    mask[:, 0::2] = keep
    mask[:, 1::2] = cross
    # stable-compact kept slots to the front, preserving ring order
    order = np.argsort(~mask, axis=1, kind="stable")
    out = np.take_along_axis(out, order[:, :, None], axis=1)
    return out, mask.sum(axis=1)


def _poly_areas_batch(V, n):
    """Shoelace over (M, K, 2) buffers with (M,) live counts."""
    m, k, _ = V.shape
    idx = np.arange(k)
    live = idx[None, :] < n[:, None]
    nxt_i = np.where(idx[None, :] + 1 < n[:, None], idx[None, :] + 1, 0)
    nxt = np.take_along_axis(V, nxt_i[:, :, None], axis=1)
    term = V[:, :, 0] * nxt[:, :, 1] - V[:, :, 1] * nxt[:, :, 0]
    area = 0.5 * np.abs(np.sum(np.where(live, term, 0.0), axis=1))
    return np.where(n >= 3, area, 0.0)


def _aabb_half_extents(boxes5):
    """(P, 5) -> (P,) x and (P,) z half-extents of the rotated rects'
    axis-aligned bounding boxes: (|l c| + |w s|) / 2 etc."""
    c, s = np.cos(boxes5[:, 4]), np.sin(boxes5[:, 4])
    hx = (np.abs(boxes5[:, 2] * c) + np.abs(boxes5[:, 3] * s)) / 2.0
    hz = (np.abs(boxes5[:, 2] * s) + np.abs(boxes5[:, 3] * c)) / 2.0
    return hx, hz


def _signed_areas_batch(pts):
    """(M, V, 2) -> (M,) signed areas."""
    x, z = pts[:, :, 0], pts[:, :, 1]
    xn, zn = np.roll(x, -1, axis=1), np.roll(z, -1, axis=1)
    return 0.5 * np.sum(x * zn - z * xn, axis=1)


def rect_intersection_pairs(a5, b5) -> np.ndarray:
    """Pairwise exact rotated-rect intersection: a5 (P, 5) vs b5
    (P, 5) -> (P,) areas (row i of a against row i of b), with an
    exact AABB prescreen so the polygon clip only runs on pairs that
    can overlap."""
    a5 = np.atleast_2d(a5).astype(np.float64)
    b5 = np.atleast_2d(b5).astype(np.float64)
    p = len(a5)
    out = np.zeros(p)
    hx_a, hz_a = _aabb_half_extents(a5)
    hx_b, hz_b = _aabb_half_extents(b5)
    cand = ((np.abs(b5[:, 0] - a5[:, 0]) <= hx_a + hx_b) &
            (np.abs(b5[:, 1] - a5[:, 1]) <= hz_a + hz_b))
    if not cand.any():
        return out
    asel, bsel = a5[cand], b5[cand]
    pb = _rect_corners_batch(bsel)                          # (C, 4, 2)
    flip = _signed_areas_batch(pb) < 0
    pb[flip] = pb[flip, ::-1]
    V = _rect_corners_batch(asel)                           # (C, 4, 2)
    n = np.full(len(asel), 4)
    for i in range(4):
        V, n = _clip_polys_batch(V, n, pb[:, i],
                                 pb[:, (i + 1) % 4])
        V = V[:, :max(4, int(n.max()))]   # <=8 real vertices ever
    out[cand] = _poly_areas_batch(V, n)
    return out


def rotated_iou_matrix(boxes_a, boxes_b) -> np.ndarray:
    """(T, 5) x (D, 5) BEV rotated IoU [x, z, l, w, ry] -> (T, D) in one
    pairwise sweep."""
    boxes_a = np.atleast_2d(boxes_a).astype(np.float64)
    boxes_b = np.atleast_2d(boxes_b).astype(np.float64)
    t, d = len(boxes_a), len(boxes_b)
    if t == 0 or d == 0:
        return np.zeros((t, d))
    pa = np.repeat(boxes_a, d, axis=0)
    pb = np.tile(boxes_b, (t, 1))
    inter = rect_intersection_pairs(pa, pb)
    union = pa[:, 2] * pa[:, 3] + pb[:, 2] * pb[:, 3] - inter
    return np.where(union > 0, inter / union, 0.0).reshape(t, d)
