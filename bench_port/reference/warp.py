"""Ego-motion BEV feature warp for streaming inference (PyTorch port of
dodt_tpu/ops/warp.py, four-gather bilinear form).

The BEV map is a metric x/z grid, so ego motion between keyframes is a
2D affine map of it: a cached frame's features are resampled into
another frame's coordinates instead of re-encoding its towers.
"""
from __future__ import annotations

import numpy as np
import torch


def bev_pixel_from_xz(x, z, bev_extents, h: int, w: int):
    """Metric (x, z) -> (row, col) BEV pixel coordinates, tensors or
    floats: half-pixel convention, z flipped (as the projection to the
    BEV and the ROI sampling)."""
    x0, x1 = bev_extents[0][0], bev_extents[0][1]
    z0, z1 = bev_extents[1][0], bev_extents[1][1]
    col = (x - x0) / (x1 - x0) * w - 0.5
    row = (z1 - z) / (z1 - z0) * h - 0.5
    return row, col


def _src_grid(h: int, w: int, a2: torch.Tensor, b2: torch.Tensor, ae):
    """Source-frame (row, col) sample coordinates of every destination
    pixel under the affine metric map, plus the in-range mask."""
    dev = a2.device
    x0, x1 = ae[0][0], ae[0][1]
    z0, z1 = ae[1][0], ae[1][1]
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    x_dst = (cols + 0.5) / w * float(x1 - x0) + float(x0)
    z_dst = float(z1) - (rows + 0.5) / h * float(z1 - z0)
    zg, xg = torch.meshgrid(z_dst, x_dst, indexing="ij")     # (H, W)
    x_src = a2[0, 0] * xg + a2[0, 1] * zg + b2[0]
    z_src = a2[1, 0] * xg + a2[1, 1] * zg + b2[1]
    r_src, c_src = bev_pixel_from_xz(x_src, z_src, ae, h, w)
    inside = ((r_src >= 0) & (r_src <= h - 1) &
              (c_src >= 0) & (c_src <= w - 1))
    return r_src, c_src, inside


def warp_bev_features(feats: torch.Tensor, a2: torch.Tensor,
                      b2: torch.Tensor, bev_extents) -> torch.Tensor:
    """Resample a source-frame BEV map (H, W, C) so that output location
    (x_dst, z_dst) reads source metric coords a2 @ [x_dst, z_dst] + b2.
    Out-of-range samples are zero."""
    h, w, _ = feats.shape
    ae = np.asarray(bev_extents, np.float32)
    a2 = a2.to(torch.float32)
    b2 = b2.to(torch.float32)
    r_src, c_src, inside = _src_grid(h, w, a2, b2, ae)
    r = torch.clamp(r_src, 0.0, h - 1)
    cc = torch.clamp(c_src, 0.0, w - 1)
    r0f = torch.floor(r)
    c0f = torch.floor(cc)
    r0 = r0f.to(torch.int64)
    c0 = c0f.to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    fr = (r - r0f)[..., None]
    fc = (cc - c0f)[..., None]
    tl, tr = feats[r0, c0], feats[r0, c1]
    bl, br = feats[r1, c0], feats[r1, c1]
    top = tl + (tr - tl) * fc
    bot = bl + (br - bl) * fc
    out = top + (bot - top) * fr
    return out * inside[..., None]


def transform_anchors_xz(anchors: torch.Tensor, a2: torch.Tensor,
                         b2: torch.Tensor) -> torch.Tensor:
    """Move (..., 6) anchors between frames: centres by the affine,
    footprint dims by the ortho projection of the rotated extents."""
    a2 = a2.to(torch.float32)
    b2 = b2.to(torch.float32)
    x = anchors[..., 0]
    z = anchors[..., 2]
    nx = a2[0, 0] * x + a2[0, 1] * z + b2[0]
    nz = a2[1, 0] * x + a2[1, 1] * z + b2[1]
    cos_t = torch.abs(a2[0, 0])
    sin_t = torch.abs(a2[0, 1])
    dx = anchors[..., 3]
    dz = anchors[..., 5]
    return torch.stack([nx, anchors[..., 1], nz, dx * cos_t + dz * sin_t,
                        anchors[..., 4], dx * sin_t + dz * cos_t], dim=-1)
