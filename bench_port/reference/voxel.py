"""BEV rasterization of a padded point cloud (PyTorch port of
dodt_tpu/ops/voxel.py) as ``scatter_reduce`` passes.

Semantics parity notes (kept from the JAX package):
  * slice membership uses the UNNORMALIZED plane offset a*x+b*y+c*z+d
    (reference get_point_filter:453 builds filters from the raw dot
    product), while the stored height uses the normalized point-to-
    plane distance (voxel_grid_2d.py:104 uses dist_to_plane);
  * per-cell height is the max plane distance over points in the cell
    (the reference takes the first point after a (x, z, y) lexsort =
    min y, which equals max height for any ground plane whose normal is
    y-dominant — true for every KITTI plane);
  * density = min(1, log(N+1)/log(16)) (bev_generator.py:23);
  * map layout: row = flipped z (row 0 = far), col = x (bev_slices
    113-116 transpose + flip);
  * a quotient by a constant (the voxel size, the slice height, log 16)
    is a multiply by the constant's f32 reciprocal, as jitted XLA
    rewrites it: the true quotient puts a point that lies within an ulp
    of a cell edge in the neighbouring cell. The card computes the same
    bits, since both sides multiply. Jitted XLA also contracts the plane
    offset's multiply-adds into FMAs (``plane_offset``), and its val
    forward and its train step take these forms alike (ROADMAP C24);
  * the density of a cell of n points takes one of 16 values (n >= 15
    saturates), read from a table: ``torch.log`` on the CPU is not always
    correctly rounded on its first call in a process (ROADMAP C24), and
    the table gives the card the CPU's bits.

Dropped points (outside the extents or the height band) scatter into one
extra dump slot past the end of each target, which is sliced off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BevMaps(NamedTuple):
    features: torch.Tensor     # (H, W, num_slices + 1) height slices+density
    occupancy: torch.Tensor    # (X, Z) 0/1 cell occupancy (native layout)


def xla_reciprocal(c: float) -> float:
    """1 / c as jitted XLA folds it for a quotient by the constant c: the
    f32 reciprocal of the f32 constant."""
    return float(np.float32(1.0) / np.float32(c))


INV_LOG16 = xla_reciprocal(np.log(np.float32(16.0)))
# min(1, log(n + 1) / log 16) for n = 0..15 points in a cell, as jitted
# XLA computes it (f32 log times INV_LOG16); 15 or more points give 1
DENSITY = np.minimum(np.log(np.arange(1, 17, dtype=np.float32))
                     * np.float32(INV_LOG16), np.float32(1.0))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, as an FMA: the f32 product is exact in
    f64, and the f64 sum rounds to the FMA's f32 but for sums within an
    f64 ulp of an f32 rounding midpoint."""
    return (a.double() * b.double() + c.double()).float()


def plane_offset(points: torch.Tensor, gp: torch.Tensor) -> torch.Tensor:
    """a*x + b*y + c*z + d of points (P, 3) on plane (4,), as jitted XLA
    contracts it: fma(c, z, fma(a, x, b * y)) + d."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return _fma(gp[2], z, _fma(gp[0], x, gp[1] * y)) + gp[3]


def _scatter(size: int, idx: torch.Tensor, val: torch.Tensor,
             reduce: str) -> torch.Tensor:
    out = torch.zeros(size + 1, dtype=torch.float32, device=val.device)
    out.scatter_reduce_(0, idx.to(torch.int64), val, reduce=reduce,
                        include_self=True)
    return out[:size]


def bev_maps_from_points(points: torch.Tensor, valid: torch.Tensor,
                         ground_plane: torch.Tensor, area_extents,
                         voxel_size: float, height_lo: float,
                         height_hi: float, num_slices: int) -> BevMaps:
    """Rasterize points (P, 3) with mask (P,) on plane (4,) into
    features (H, W, num_slices + 1) and occupancy (X, Z)."""
    ae = np.asarray(area_extents, np.float32)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    gp = ground_plane.to(torch.float32)

    nx = int(round(float(area_extents[0][1] - area_extents[0][0])
                   / voxel_size))
    nz = int(round(float(area_extents[2][1] - area_extents[2][0])
                   / voxel_size))
    div = (height_hi - height_lo) / num_slices
    inv_vs, inv_div = xla_reciprocal(voxel_size), xla_reciprocal(div)

    # extent filter: strict inequalities (reference get_point_filter:453)
    in_area = ((x > float(ae[0, 0])) & (x < float(ae[0, 1])) &
               (y > float(ae[1, 0])) & (y < float(ae[1, 1])) &
               (z > float(ae[2, 0])) & (z < float(ae[2, 1])) & valid)

    plane_dot = plane_offset(points, gp)
    dist = plane_dot / torch.linalg.vector_norm(gp[0:3])
    in_band = in_area & (plane_dot >= height_lo) & (plane_dot < height_hi)

    xi = torch.floor((x - float(ae[0, 0])) * inv_vs).to(torch.int32)
    zi = torch.floor((z - float(ae[2, 0])) * inv_vs).to(torch.int32)
    xi = torch.clamp(xi, 0, nx - 1)
    zi = torch.clamp(zi, 0, nz - 1)
    row = nz - 1 - zi
    col = xi

    slice_id = torch.floor((plane_dot - height_lo) * inv_div).to(torch.int32)
    slice_id = torch.clamp(slice_id, 0, num_slices - 1)

    # height slices: one scatter-max over (S, H, W)
    n_hw = nz * nx
    flat_idx = torch.where(in_band, (slice_id * nz + row) * nx + col,
                           num_slices * n_hw)
    slice_lo = height_lo + slice_id.to(torch.float32) * div
    norm_height = (dist - slice_lo) * inv_div
    heights = _scatter(num_slices * n_hw, flat_idx,
                       torch.where(in_band, norm_height, 0.0), "amax")
    height_maps = heights.reshape(num_slices, nz, nx)

    # density over the full band
    ones = in_band.to(torch.float32)
    cell_idx = torch.where(in_band, row * nx + col, n_hw)
    counts = _scatter(n_hw, cell_idx, ones, "sum")
    table = torch.as_tensor(DENSITY, device=counts.device)
    density = table[torch.clamp(counts, max=15.0).long()].reshape(nz, nx)

    features = torch.cat([height_maps.permute(1, 2, 0), density[..., None]],
                         dim=-1)

    # occupancy in native (x, z) layout for anchor filtering
    occ_idx = torch.where(in_band, xi * nz + zi, n_hw)
    occupancy = _scatter(n_hw, occ_idx, ones, "amax").reshape(nx, nz)
    return BevMaps(features=features, occupancy=occupancy)


def points_in_area_mask(points: torch.Tensor, valid: torch.Tensor,
                        ground_plane, area_extents,
                        offset_dist: float = 2.0) -> torch.Tensor:
    """The reference's get_point_filter: points (P, 3) strictly inside the
    extents and below the ground plane shifted up by ``offset_dist``
    (plane_dot < offset_dist), and ``valid``."""
    ae = torch.as_tensor(np.asarray(area_extents, np.float32),
                         device=points.device)
    gp = torch.as_tensor(ground_plane, dtype=torch.float32,
                         device=points.device)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    in_area = ((x > ae[0, 0]) & (x < ae[0, 1]) & (y > ae[1, 0])
               & (y < ae[1, 1]) & (z > ae[2, 0]) & (z < ae[2, 1]))
    plane_dot = gp[0] * x + gp[1] * y + gp[2] * z + gp[3]
    return in_area & (plane_dot < offset_dist) & valid.bool()
