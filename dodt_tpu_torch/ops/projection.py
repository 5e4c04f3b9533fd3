"""Projection of anchors into BEV and image space, and of points into
the image (PyTorch port of dodt_tpu/ops/projection.py)."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _bev_ranges(rx: float, rz: float, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """[rx, rz, rx, rz] in ``dtype``, made on the CPU and kept per device:
    a tensor built from host values on every call is a copy to the card
    that waits for it, and cannot be captured in a CUDA graph."""
    return torch.tensor([rx, rz, rx, rz], dtype=dtype).to(device)


def project_to_bev(anchors: torch.Tensor, bev_extents):
    """Anchors (..., 6) -> BEV boxes (..., 4) [x1, z1, x2, z2] with the
    origin at the top-left (z flipped), and the same normalised to
    [0, 1]. ``bev_extents``: [[x_min, x_max], [z_min, z_max]]."""
    ext = np.asarray(bev_extents, np.float32)
    x_min, x_max = float(ext[0, 0]), float(ext[0, 1])
    z_min, z_max = float(ext[1, 0]), float(ext[1, 1])
    x = anchors[..., 0]
    z = anchors[..., 2]
    half_x = anchors[..., 3] / 2.0
    half_z = anchors[..., 5] / 2.0
    x1 = x - half_x - x_min
    x2 = x + half_x - x_min
    z1 = z_max - (z + half_z) - z_min
    z2 = z_max - (z - half_z) - z_min
    corners = torch.stack([x1, z1, x2, z2], dim=-1)
    rx, rz = float(ext[0, 1] - ext[0, 0]), float(ext[1, 1] - ext[1, 0])
    # a tensor divisor: a CUDA tensor divided by a Python number is
    # multiplied by its rounded reciprocal (ops/roi._unit_grid)
    return corners, corners / _bev_ranges(rx, rz, anchors.dtype,
                                          anchors.device)


def project_to_image_space(anchors: torch.Tensor, p2: torch.Tensor,
                           image_shape: torch.Tensor):
    """Anchor cuboids (..., 6) -> image boxes (..., 4) [x1, y1, x2, y2],
    clipped to the image, and the same normalised by (w, h).

    p2: (3, 4) camera matrix; image_shape: (2,) (h, w) as floats.
    """
    x, y, z = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    hx = anchors[..., 3] / 2.0
    dy = anchors[..., 4]
    hz = anchors[..., 5] / 2.0
    xc = torch.stack([x + hx, x + hx, x - hx, x - hx,
                      x + hx, x + hx, x - hx, x - hx], dim=-1)
    yc = torch.stack([y, y, y, y, y - dy, y - dy, y - dy, y - dy], dim=-1)
    zc = torch.stack([z + hz, z - hz, z - hz, z + hz,
                      z + hz, z - hz, z - hz, z + hz], dim=-1)
    pts = torch.stack([xc, yc, zc, torch.ones_like(xc)], dim=-2)  # (..,4,8)
    proj = torch.matmul(p2.to(torch.float32), pts)                # (..,3,8)
    u = proj[..., 0, :] / proj[..., 2, :]
    v = proj[..., 1, :] / proj[..., 2, :]
    h = image_shape[0].to(torch.float32)
    w = image_shape[1].to(torch.float32)
    x1 = torch.minimum(torch.clamp(u.amin(-1), min=0.0), w)
    x2 = torch.minimum(torch.clamp(u.amax(-1), min=0.0), w)
    y1 = torch.minimum(torch.clamp(v.amin(-1), min=0.0), h)
    y2 = torch.minimum(torch.clamp(v.amax(-1), min=0.0), h)
    corners = torch.stack([x1, y1, x2, y2], dim=-1)
    return corners, corners / torch.stack([w, h, w, h])


def reorder_boxes_yx(boxes_xy: torch.Tensor) -> torch.Tensor:
    """[x1, y1, x2, y2] -> [y1, x1, y2, x2] (crop-and-resize order): each
    corner's pair flipped, with no index tensor copied from the host."""
    return boxes_xy.unflatten(-1, (2, 2)).flip(-1).flatten(-2)


def project_points_to_image(points: torch.Tensor, p2) -> torch.Tensor:
    """3D camera-frame points (..., 3) -> image pixels (..., 2) through
    the (3, 4) camera matrix ``p2``."""
    p2 = torch.as_tensor(p2, dtype=torch.float32, device=points.device)
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    proj = torch.einsum("ij,...j->...i", p2, pts_h)
    return proj[..., 0:2] / proj[..., 2:3]
