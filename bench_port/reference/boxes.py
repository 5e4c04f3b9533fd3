"""Box representations and codecs used by the streaming path and the
losses (PyTorch port of dodt_tpu/ops/boxes.py; batched leading axes
everywhere).

  box_3d : [x, y, z, l, w, h, ry]       camera frame, y = bottom face
  anchor : [x, y, z, dim_x, dim_y, dim_z]  axis-aligned cuboid
  box_4c : [x1..x4, z1..z4, h1, h2]     4 ground corners + 2 heights
  box_8c : (..., 3, 8) corner matrix
"""
from __future__ import annotations

import math

import torch

HALF_PI = math.pi / 2.0


def box_3d_to_anchor(boxes_3d: torch.Tensor, ortho_rotate: bool = False
                     ) -> torch.Tensor:
    """box_3d (..., 7) -> axis-aligned anchor (..., 6); the footprint is
    projected onto x/z, after snapping ry to a multiple of 90 degrees
    with ``ortho_rotate``."""
    x, y, z, l, w, h, ry = boxes_3d.unbind(-1)
    if ortho_rotate:
        ry = torch.round(ry / HALF_PI) * HALF_PI
    cos_ry = torch.abs(torch.cos(ry))
    sin_ry = torch.abs(torch.sin(ry))
    dim_x = l * cos_ry + w * sin_ry
    dim_z = w * cos_ry + l * sin_ry
    return torch.stack([x, y, z, dim_x, h, dim_z], dim=-1)


def anchors_to_box_3d(anchors: torch.Tensor, fix_lw: bool = False
                      ) -> torch.Tensor:
    """Anchors (..., 6) -> box_3d (..., 7) with ry = 0; with ``fix_lw``
    boxes wider than long swap l/w and take ry = -pi/2."""
    x, y, z, dim_x, dim_y, dim_z = anchors.unbind(-1)
    l, w = dim_x, dim_z
    ry = torch.zeros_like(x)
    if fix_lw:
        swap = w > l
        l, w = torch.where(swap, w, l), torch.where(swap, l, w)
        ry = torch.where(swap, torch.full_like(ry, -HALF_PI), ry)
    return torch.stack([x, y, z, l, w, dim_y, ry], dim=-1)


def anchor_to_offset(anchors: torch.Tensor, gt_anchors: torch.Tensor
                     ) -> torch.Tensor:
    """Encode matched GT anchors (..., 6) as offsets (..., 6) against
    anchors: [dx/dim_x, dy/dim_y, dz/dim_z, log(dim_gt/dim), ...]."""
    t_xyz = (gt_anchors[..., 0:3] - anchors[..., 0:3]) / anchors[..., 3:6]
    t_dim = torch.log(gt_anchors[..., 3:6] / anchors[..., 3:6])
    return torch.cat([t_xyz, t_dim], dim=-1)


def offset_to_anchor(anchors: torch.Tensor, offsets: torch.Tensor
                     ) -> torch.Tensor:
    """Decode regression offsets (..., 6) against anchors (..., 6)."""
    xyz = offsets[..., 0:3] * anchors[..., 3:6] + anchors[..., 0:3]
    dim = torch.exp(torch.log(anchors[..., 3:6]) + offsets[..., 3:6])
    return torch.cat([xyz, dim], dim=-1)


def orientation_to_angle_vector(ry: torch.Tensor) -> torch.Tensor:
    """ry (...,) -> unit angle vector (..., 2)."""
    return torch.stack([torch.cos(ry), torch.sin(ry)], dim=-1)


def angle_vector_to_orientation(vec: torch.Tensor) -> torch.Tensor:
    """(..., 2) angle vector -> ry (...,)."""
    return torch.atan2(vec[..., 1], vec[..., 0])


def box_3d_to_corners(boxes_3d: torch.Tensor) -> torch.Tensor:
    """box_3d (..., 7) -> corners (..., 3, 8): the bottom face first (x:
    +,+,-,-; z: +,-,-,+ before rotation), then the top face in the same
    x/z order, rotated by ry about the camera y axis."""
    x, y, z, l, w, h, ry = boxes_3d.unbind(-1)
    l2, w2 = l / 2.0, w / 2.0
    x_c = torch.stack([l2, l2, -l2, -l2, l2, l2, -l2, -l2], dim=-1)
    z_c = torch.stack([w2, -w2, -w2, w2, w2, -w2, -w2, w2], dim=-1)
    zeros = torch.zeros_like(l2)
    y_c = torch.stack([zeros] * 4 + [-h] * 4, dim=-1)
    cos_ry, sin_ry = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x_r = cos_ry * x_c + sin_ry * z_c
    z_r = -sin_ry * x_c + cos_ry * z_c
    return torch.stack([x_r + x[..., None], y_c + y[..., None],
                        z_r + z[..., None]], dim=-2)


def box_3d_to_box_4c(boxes_3d: torch.Tensor, ground_plane: torch.Tensor
                     ) -> torch.Tensor:
    """box_3d (..., 7) -> box_4c (..., 10) on the ground plane (..., 4).

    The footprint is snapped to the nearest 90-degree multiple (l/w
    swapped when that is vertical) and the residual rotation applied to
    the corners, ordered (+x,+z), (+x,-z), (-x,-z), (-x,+z); h1/h2 are
    the bottom/top heights above the plane.
    """
    x, y, z, l, w, h, ry = boxes_3d.unbind(-1)
    ortho_ry = torch.round(ry / HALF_PI) * HALF_PI
    rot_delta = ry - ortho_ry
    is_vert = (torch.round(ortho_ry / HALF_PI).to(torch.int32) % 2) != 0
    eff_l = torch.where(is_vert, w, l)
    eff_w = torch.where(is_vert, l, w)

    l2, w2 = eff_l / 2.0, eff_w / 2.0
    x_c = torch.stack([l2, l2, -l2, -l2], dim=-1)
    z_c = torch.stack([w2, -w2, -w2, w2], dim=-1)
    cos_d = torch.cos(rot_delta)[..., None]
    sin_d = torch.sin(rot_delta)[..., None]
    x_corners = cos_d * x_c + sin_d * z_c + x[..., None]
    z_corners = -sin_d * x_c + cos_d * z_c + z[..., None]

    ground_y = -(ground_plane[..., 0] * x + ground_plane[..., 2] * z
                 + ground_plane[..., 3]) / ground_plane[..., 1]
    h1 = ground_y - y
    h2 = h1 + h
    return torch.cat([x_corners, z_corners, h1[..., None], h2[..., None]],
                     dim=-1)


def _box_4c_axis_info(vec_x, vec_z, px, pz, mid_x, mid_z):
    """Project the 4 corners onto a direction and its normal; recover
    centroid, length, width and ry. Like the reference, the centroid
    moves along the normal by (max_w + min_w), not half of it."""
    mag = torch.clamp(torch.hypot(vec_x, vec_z), min=1e-10)
    nx, nz = vec_x / mag, vec_z / mag
    rel_x = px - mid_x[..., None]
    rel_z = pz - mid_z[..., None]
    ls = rel_x * nx[..., None] + rel_z * nz[..., None]
    min_l = ls.amin(-1)
    max_l = ls.amax(-1)
    ws = rel_x * (-nz[..., None]) + rel_z * nx[..., None]
    min_w = ws.amin(-1)
    max_w = ws.amax(-1)
    w_diff = max_w + min_w
    half_span = (min_l + max_l) / 2.0
    cx = mid_x + nx * half_span + (-nz) * w_diff
    cz = mid_z + nz * half_span + nx * w_diff
    ry = -torch.atan2(vec_z, vec_x)
    return cx, cz, max_l - min_l, max_w - min_w, ry


def box_4c_to_box_3d(boxes_4c: torch.Tensor, ground_plane: torch.Tensor
                     ) -> torch.Tensor:
    """box_4c (..., 10) -> box_3d (..., 7): the longer midpoint-to-
    midpoint vector of the quad gives the orientation, the projected
    extents give length and width."""
    xs = boxes_4c[..., 0:4]
    zs = boxes_4c[..., 4:8]
    h1 = boxes_4c[..., 8]
    h2 = boxes_4c[..., 9]

    m12x, m12z = (xs[..., 0] + xs[..., 1]) / 2, (zs[..., 0] + zs[..., 1]) / 2
    m23x, m23z = (xs[..., 1] + xs[..., 2]) / 2, (zs[..., 1] + zs[..., 2]) / 2
    m34x, m34z = (xs[..., 2] + xs[..., 3]) / 2, (zs[..., 2] + zs[..., 3]) / 2
    m14x, m14z = (xs[..., 0] + xs[..., 3]) / 2, (zs[..., 0] + zs[..., 3]) / 2

    va_x, va_z = m12x - m34x, m12z - m34z
    vb_x, vb_z = m14x - m23x, m14z - m23z
    use_a = torch.hypot(va_x, va_z) > torch.hypot(vb_x, vb_z)

    a = _box_4c_axis_info(va_x, va_z, xs, zs, m34x, m34z)
    b = _box_4c_axis_info(vb_x, vb_z, xs, zs, m23x, m23z)
    cx, cz, l, w, ry = (torch.where(use_a, ai, bi) for ai, bi in zip(a, b))

    ground_y = -(ground_plane[..., 0] * cx + ground_plane[..., 2] * cz
                 + ground_plane[..., 3]) / ground_plane[..., 1]
    return torch.stack([cx, ground_y - h1, cz, l, w, h2 - h1, ry], dim=-1)


def box_4c_to_offsets(boxes_4c: torch.Tensor, gt_boxes_4c: torch.Tensor
                      ) -> torch.Tensor:
    """Plain difference codec."""
    return gt_boxes_4c - boxes_4c


def offsets_to_box_4c(boxes_4c: torch.Tensor, offsets: torch.Tensor
                      ) -> torch.Tensor:
    return boxes_4c + offsets


def box_3d_to_box_8c(boxes_3d: torch.Tensor) -> torch.Tensor:
    """box_3d (..., 7) -> (..., 3, 8) corners (``box_3d_to_corners``)."""
    return box_3d_to_corners(boxes_3d)


def box_8c_to_box_3d(boxes_8c: torch.Tensor) -> torch.Tensor:
    """(..., 3, 8) corners -> box_3d: centroid from the corner mean,
    bottom y and height from the face means, length and width from the
    averaged bottom-face edges, ry from their averaged length direction."""
    x_c, y_c, z_c = boxes_8c[..., 0, :], boxes_8c[..., 1, :], \
        boxes_8c[..., 2, :]
    cx = x_c.mean(-1)
    cz = z_c.mean(-1)
    y_bottom = y_c[..., 0:4].mean(-1)
    h = y_bottom - y_c[..., 4:8].mean(-1)
    # bottom-face edges 0-3 / 1-2 are length edges, 0-1 / 3-2 width edges
    lx1, lz1 = x_c[..., 0] - x_c[..., 3], z_c[..., 0] - z_c[..., 3]
    lx2, lz2 = x_c[..., 1] - x_c[..., 2], z_c[..., 1] - z_c[..., 2]
    wx1, wz1 = x_c[..., 0] - x_c[..., 1], z_c[..., 0] - z_c[..., 1]
    wx2, wz2 = x_c[..., 3] - x_c[..., 2], z_c[..., 3] - z_c[..., 2]
    l = (torch.hypot(lx1, lz1) + torch.hypot(lx2, lz2)) / 2.0
    w = (torch.hypot(wx1, wz1) + torch.hypot(wx2, wz2)) / 2.0
    ry = torch.atan2(-(lz1 + lz2) / 2.0, (lx1 + lx2) / 2.0)
    return torch.stack([cx, y_bottom, cz, l, w, h, ry], dim=-1)
