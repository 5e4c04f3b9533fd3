"""Dense all-anchor RPN features over the regular anchor grid (PyTorch
port of dodt_tpu/ops/dense_rpn.py).

The anchor grid is regular: every sample point of every anchor of one
(size, rotation) config lies on an exact ``p``-pixel lattice of the BEV
map with static fractional offsets (half-pixel crop convention,
ops/roi.py). So the all-anchor ROI crop is a strided row pass and a
strided column pass with static bilinear weights, and the occupancy
filter is four strided taps of the integral image. Out-of-range samples
clamp to the map edge, reproduced by edge-replicated (clamped) indices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BevLattice:
    """Static sampling geometry of the regular anchor grid.

    nz, nx: anchor grid cells (rows = z, cols = x).
    period: lattice period in feature-map pixels (= stride / voxel).
    row_off/col_off: (n_cfg, S) int floor offsets of each sample point
      relative to the p*i lattice origin (may be negative).
    row_frac/col_frac: (n_cfg, S) static bilinear fractions.
    mask_x_off/mask_z_off: (n_cfg, 2) int corner-cell offsets of each
      config's footprint in the (unflipped) occupancy grid.
    """
    nz: int
    nx: int
    period: int
    row_off: np.ndarray
    row_frac: np.ndarray
    col_off: np.ndarray
    col_frac: np.ndarray
    mask_x_off: np.ndarray
    mask_z_off: np.ndarray
    n_cfg: int
    crop_size: int


def _config_dims(anchor_sizes) -> np.ndarray:
    """Per-config BEV half-dims (halfx, halfz), configs ordered (size,
    rotation) like tile_anchors_3d, in box_3d_to_anchor's float32
    arithmetic."""
    sizes = np.asarray(anchor_sizes, np.float32).reshape(-1, 3)
    out = []
    for l, w, _h in sizes:
        for ry in (np.float32(0.0), np.float32(np.pi / 2.0)):
            cos_ry = np.abs(np.cos(ry, dtype=np.float32))
            sin_ry = np.abs(np.sin(ry, dtype=np.float32))
            out.append(((l * cos_ry + w * sin_ry) / 2.0,
                        (w * cos_ry + l * sin_ry) / 2.0))
    return np.asarray(out, np.float32)


def build_bev_lattice(area_extents, anchor_stride, anchor_sizes,
                      bev_shape: Tuple[int, int], voxel_size: float,
                      crop_size: int) -> Optional[BevLattice]:
    """The static lattice, or None if the geometry is not an exact pixel
    lattice (the caller then crops per anchor)."""
    area = np.asarray(area_extents, np.float64)
    sx, sz = float(anchor_stride[0]), float(anchor_stride[1])
    h, w = bev_shape
    x_extent = area[0][1] - area[0][0]
    z_extent = area[2][1] - area[2][0]
    px = sx / voxel_size
    pz = sz / voxel_size
    if abs(px - round(px)) > 1e-9 or abs(pz - round(pz)) > 1e-9:
        return None
    if round(px) != round(pz):
        return None
    if abs(w * voxel_size - x_extent) > 1e-9:
        return None
    if abs(h * voxel_size - z_extent) > 1e-9:
        return None
    p = int(round(px))
    nx = int(np.ceil((x_extent - sx / 2.0) / sx))
    nz = int(np.ceil((z_extent - sz / 2.0) / sz))

    dims = _config_dims(anchor_sizes)
    n_cfg = dims.shape[0]
    s = crop_size
    grid = (np.arange(s, dtype=np.float32) / (s - 1) if s > 1
            else np.asarray([0.5], np.float32))
    row_off = np.zeros((n_cfg, s), np.int64)
    row_frac = np.zeros((n_cfg, s), np.float32)
    col_off = np.zeros((n_cfg, s), np.int64)
    col_frac = np.zeros((n_cfg, s), np.float32)
    mask_x_off = np.zeros((n_cfg, 2), np.int64)
    mask_z_off = np.zeros((n_cfg, 2), np.int64)
    zbase = (z_extent - sz / 2.0) / voxel_size - p * (nz - 1)
    for c in range(n_cfg):
        halfx, halfz = float(dims[c, 0]), float(dims[c, 1])
        for k in range(s):
            g = float(grid[k]) if s > 1 else 0.5
            # sample pixel = p * i + (stride/2 - half + 2*half*g)/voxel - .5
            cx = (sx / 2.0 - halfx + 2.0 * halfx * g) / voxel_size - 0.5
            cy = (sz / 2.0 - halfz + 2.0 * halfz * g) / voxel_size - 0.5
            col_off[c, k] = int(np.floor(cx))
            col_frac[c, k] = np.float32(cx - np.floor(cx))
            row_off[c, k] = int(np.floor(cy))
            row_frac[c, k] = np.float32(cy - np.floor(cy))
        # occupancy corner cells (floor), z grid descending from z_max
        mask_x_off[c, 0] = int(np.floor((sx / 2.0 - halfx) / voxel_size))
        mask_x_off[c, 1] = int(np.floor((sx / 2.0 + halfx) / voxel_size))
        mask_z_off[c, 0] = int(np.floor(zbase - halfz / voxel_size))
        mask_z_off[c, 1] = int(np.floor(zbase + halfz / voxel_size))
    return BevLattice(nz=nz, nx=nx, period=p, row_off=row_off,
                      row_frac=row_frac, col_off=col_off,
                      col_frac=col_frac, mask_x_off=mask_x_off,
                      mask_z_off=mask_z_off, n_cfg=n_cfg, crop_size=s)


def dense_bev_rois(fm: torch.Tensor, lat: BevLattice) -> torch.Tensor:
    """All-anchor BEV ROI crops of fm (H, W, C) without per-anchor
    gathers: (nz * nx * n_cfg, S, S, C), flat index ordered (iz, ix,
    cfg) like tile_anchors_3d."""
    p, s = lat.period, lat.crop_size
    nz, nx, n_cfg = lat.nz, lat.nx, lat.n_cfg
    h, w, c_ch = fm.shape
    dev = fm.device
    # row pass: sample rows p*iz + off and the next one, per (cfg, i)
    r0 = torch.as_tensor(lat.row_off.reshape(-1, 1), device=dev) \
        + p * torch.arange(nz, device=dev)                  # (cfg*S, nz)
    fy = torch.as_tensor(lat.row_frac.reshape(-1, 1, 1, 1), device=dev)
    top = fm[torch.clamp(r0, 0, h - 1)]                     # (cfg*S,nz,W,C)
    bot = fm[torch.clamp(r0 + 1, 0, h - 1)]
    rows = (top + (bot - top) * fy).reshape(n_cfg, s, nz, w, c_ch)
    # column pass per (cfg, j)
    c0 = torch.as_tensor(lat.col_off[:, :, None], device=dev) \
        + p * torch.arange(nx, device=dev)                  # (cfg, S, nx)
    fx = torch.as_tensor(lat.col_frac, device=dev)[:, None, None, :, None,
                                                        None]
    ci0 = torch.clamp(c0, 0, w - 1)
    ci1 = torch.clamp(c0 + 1, 0, w - 1)
    # gather columns: rows (cfg, S_i, nz, W, C) -> (cfg, S_i, nz, S_j, nx, C)
    left = torch.stack([rows[k][:, :, ci0[k]] for k in range(n_cfg)])
    right = torch.stack([rows[k][:, :, ci1[k]] for k in range(n_cfg)])
    out = left + (right - left) * fx          # (cfg, S_i, nz, S_j, nx, C)
    out = out.permute(2, 4, 0, 1, 3, 5)       # (nz, nx, cfg, S_i, S_j, C)
    return out.reshape(nz * nx * n_cfg, s, s, c_ch)


def dense_occupancy_counts(integral_2d: torch.Tensor, lat: BevLattice
                           ) -> torch.Tensor:
    """Occupied-cell counts under every anchor footprint: four strided
    taps of the (X+1, Z+1) integral image (indexed [x_cell, z_cell],
    unflipped), corner indices clamped like the per-anchor filter.
    Returns (nz * nx * n_cfg,) counts in anchor order (iz, ix, cfg)."""
    p = lat.period
    n_x, n_z = integral_2d.shape
    dev = integral_2d.device
    ix = p * torch.arange(lat.nx, device=dev)
    jz = p * torch.arange(lat.nz, device=dev)
    outs = []
    for c in range(lat.n_cfg):
        x1 = torch.clamp(ix + int(lat.mask_x_off[c, 0]), 0, n_x - 1)
        x2 = torch.clamp(ix + int(lat.mask_x_off[c, 1]) + 1, 0, n_x - 1)
        z1 = torch.clamp(jz + int(lat.mask_z_off[c, 0]), 0, n_z - 1)
        z2 = torch.clamp(jz + int(lat.mask_z_off[c, 1]) + 1, 0, n_z - 1)
        v_x2 = integral_2d[x2]
        v_x1 = integral_2d[x1]
        m = (v_x2[:, z2] - v_x1[:, z2]) - (v_x2[:, z1] - v_x1[:, z1])
        outs.append(m.flip(1).t())            # (ix, jz) -> (iz, ix)
    return torch.stack(outs, dim=-1).reshape(-1)


def dense_empty_anchor_mask(integral_2d: torch.Tensor, lat: BevLattice,
                            density_threshold: int = 1) -> torch.Tensor:
    return dense_occupancy_counts(integral_2d, lat) >= density_threshold
