"""Grid anchors, the occupancy integral images (2D, and 3D with its box
query) and the per-anchor empty-anchor filter (PyTorch port of
dodt_tpu/ops/anchors.py)."""
from __future__ import annotations

import numpy as np
import torch

from .voxel import xla_reciprocal


def grid_anchor_xz(area_extents, anchor_stride) -> np.ndarray:
    """Static (N, 2) [x, z] anchor centres in the reference's (z, x)
    iteration order: x ascending from x_min + stride/2, z descending
    from z_max - stride/2."""
    area_extents = np.asarray(area_extents)
    sx, sz = float(anchor_stride[0]), float(anchor_stride[1])
    x_centers = np.arange(area_extents[0][0] + sx / 2.0,
                          area_extents[0][1], sx, dtype=np.float32)
    z_centers = np.arange(area_extents[2][1] - sz / 2.0,
                          area_extents[2][0], -sz, dtype=np.float32)
    zz, xx = np.meshgrid(z_centers, x_centers, indexing='ij')
    return np.stack([xx.ravel(), zz.ravel()], axis=1)


def tile_anchors_3d(area_extents, anchor_sizes, anchor_stride,
                    ground_plane: torch.Tensor) -> torch.Tensor:
    """Full anchor set in box_3d form (N, 7), ordered (z, x, size,
    rotation in (0, pi/2)); y sits on the ground plane (4,)."""
    dev = ground_plane.device
    xz = torch.from_numpy(grid_anchor_xz(area_extents, anchor_stride)
                          ).to(dev)
    sizes = torch.as_tensor(np.asarray(anchor_sizes, np.float32)
                            .reshape(-1, 3), device=dev)
    n_cells, n_sizes = xz.shape[0], sizes.shape[0]
    rotations = torch.tensor([0.0, np.pi / 2.0], dtype=torch.float32,
                             device=dev)
    shape = (n_cells, n_sizes, 2)
    x = xz[:, 0, None, None].expand(shape)
    z = xz[:, 1, None, None].expand(shape)
    lwh = sizes[None, :, None, :].expand(shape + (3,))
    ry = rotations[None, None, :].expand(shape)
    gp = ground_plane.to(torch.float32)
    y = -(gp[0] * x + gp[2] * z + gp[3]) / gp[1]
    boxes = torch.cat([x[..., None], y[..., None], z[..., None], lwh,
                       ry[..., None]], dim=-1)
    return boxes.reshape(-1, 7)


def integral_image_2d(grid: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H+1, W+1) zero-padded 2D prefix sum. Exact for the
    integer occupancy counts (< 2^24) in float32."""
    c = torch.cumsum(torch.cumsum(grid, dim=0), dim=1)
    return torch.nn.functional.pad(c, (1, 0, 1, 0))


def bev_occupancy_counts(integral_2d: torch.Tensor, anchors: torch.Tensor,
                         bev_extents, voxel_size: float) -> torch.Tensor:
    """Occupied-cell counts under each anchor's footprint from the
    (X+1, Z+1) zero-padded integral image of the 0/1 occupancy grid
    indexed [x_cell, z_cell]; anchors (N, 6), bev_extents [[x_min,
    x_max], [z_min, z_max]]. Corner cells are floored and clipped to the
    grid, the upper ones inclusive (reference
    anchor_filter.get_empty_anchor_filter_2d:65)."""
    nx = integral_2d.shape[0] - 1
    nz = integral_2d.shape[1] - 1
    ext = torch.as_tensor(np.asarray(bev_extents, np.float32),
                          device=anchors.device)
    x, z = anchors[:, 0], anchors[:, 2]
    half_x, half_z = anchors[:, 3] / 2.0, anchors[:, 5] / 2.0

    inv_vs = xla_reciprocal(voxel_size)     # the quotient as jitted XLA's

    def cell(v, lo, n):
        return torch.clamp(torch.floor((v - lo) * inv_vs).long(), 0, n - 1)
    x1 = cell(x - half_x, ext[0, 0], nx)
    x2 = cell(x + half_x, ext[0, 0], nx) + 1
    z1 = cell(z - half_z, ext[1, 0], nz)
    z2 = cell(z + half_z, ext[1, 0], nz) + 1
    return (integral_2d[x2, z2] - integral_2d[x1, z2]
            - integral_2d[x2, z1] + integral_2d[x1, z1])


def empty_anchor_mask(integral_2d: torch.Tensor, anchors: torch.Tensor,
                      bev_extents, voxel_size: float,
                      density_threshold: int = 1) -> torch.Tensor:
    """(N,) True for anchors over at least density_threshold occupied
    cells: a mask, not a gather."""
    return bev_occupancy_counts(integral_2d, anchors, bev_extents,
                                voxel_size) >= density_threshold


def integral_image_3d(grid: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) -> (X+1, Y+1, Z+1) prefix sum with a zero face on each
    axis (the reference's integral_images_3d.cpp:22-66)."""
    c = torch.cumsum(torch.cumsum(torch.cumsum(grid, 0), 1), 2)
    return torch.nn.functional.pad(c, (1, 0, 1, 0, 1, 0))


def query_integral_3d(integral: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """Box sums over [lo, hi) for N boxes; lo/hi (N, 3) integer indices
    into ``integral_image_3d``'s output (8-corner inclusion-exclusion)."""
    x1, y1, z1 = lo.long().unbind(-1)
    x2, y2, z2 = hi.long().unbind(-1)
    s = integral
    return (s[x2, y2, z2] - s[x1, y2, z2] - s[x2, y1, z2] - s[x2, y2, z1]
            + s[x1, y1, z2] + s[x1, y2, z1] + s[x2, y1, z1]
            - s[x1, y1, z1])
