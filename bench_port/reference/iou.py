"""IoU on device (PyTorch port of dodt_tpu/ops/iou.py): axis-aligned
(the form NMS uses), rotated-rect in the BEV (xz) plane and 3D for
gravity-aligned boxes. The JAX package vmaps a per-pair function; here
every helper takes leading batch axes, and the matrices evaluate all
pairs at once by broadcasting."""
from __future__ import annotations

import torch


def aligned_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                       ) -> torch.Tensor:
    """Pairwise IoU of boxes [x1, y1, x2, y2]: (..., N, 4) x (..., M, 4)
    -> (..., N, M). Degenerate boxes give 0."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0.0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0.0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0.0))
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(union))


# ---------------------------------------------------------------------------
# Rotated rectangle intersection (BEV, xz plane)


def _rect_corners_xz(boxes: torch.Tensor) -> torch.Tensor:
    """boxes (..., 5) [x, z, l, w, ry] -> corners (..., 4, 2) in xz: a
    point (x, z) of the box maps via x' = c*x + s*z; z' = -s*x + c*z."""
    x, z = boxes[..., 0], boxes[..., 1]
    l2, w2 = boxes[..., 2] / 2.0, boxes[..., 3] / 2.0
    xc = torch.stack([l2, l2, -l2, -l2], dim=-1)
    zc = torch.stack([w2, -w2, -w2, w2], dim=-1)
    c, s = torch.cos(boxes[..., 4])[..., None], \
        torch.sin(boxes[..., 4])[..., None]
    xr = c * xc + s * zc + x[..., None]
    zr = -s * xc + c * zc + z[..., None]
    return torch.stack([xr, zr], dim=-1)


def _polygon_area(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the masked candidate points (..., K, 2) ordered by
    angle about their centroid; invalid points sort last (stable) and sit
    on the centroid, so they do not perturb the hull. Fewer than three
    valid points give 0."""
    num_valid = mask.sum(-1)
    m2 = mask[..., None]
    centroid = (torch.where(m2, pts, 0.0).sum(-2)
                / torch.clamp(num_valid, min=1)[..., None])
    rel = pts - centroid[..., None, :]
    ang = torch.where(mask, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    p = torch.gather(torch.where(m2, rel, 0.0), -2,
                     order[..., None].expand(rel.shape))
    m = torch.gather(mask, -1, order)
    idx = torch.arange(pts.shape[-2], device=pts.device)
    nxt = torch.where(idx + 1 < num_valid[..., None], idx + 1, 0)
    p_next = torch.gather(p, -2, nxt[..., None].expand(p.shape))
    cross = p[..., 0] * p_next[..., 1] - p_next[..., 0] * p[..., 1]
    area = 0.5 * torch.abs(torch.where(m, cross, 0.0).sum(-1))
    return torch.where(num_valid >= 3, area, 0.0)


def _point_in_quad(pts: torch.Tensor, quad: torch.Tensor, eps: float = 1e-6
                   ) -> torch.Tensor:
    """pts (..., P, 2) inside the convex quad (..., 4, 2), CCW or CW."""
    edge = torch.roll(quad, -1, dims=-2) - quad              # (..., 4, 2)
    rel = pts[..., :, None, :] - quad[..., None, :, :]       # (..., P, 4, 2)
    cross = (edge[..., None, :, 0] * rel[..., 1]
             - edge[..., None, :, 1] * rel[..., 0])
    return (cross >= -eps).all(-1) | (cross <= eps).all(-1)


def _edge_intersections(qa: torch.Tensor, qb: torch.Tensor):
    """The 16 segment-segment intersection points of two quads' edges:
    (..., 16, 2) points and their (..., 16) validity."""
    reps = (1,) * (qb.dim() - 2) + (4, 1)
    a0 = qa.repeat_interleave(4, dim=-2)
    a1 = torch.roll(qa, -1, dims=-2).repeat_interleave(4, dim=-2)
    b0 = qb.repeat(reps)
    b1 = torch.roll(qb, -1, dims=-2).repeat(reps)
    da, db, diff = a1 - a0, b1 - b0, b0 - a0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    t = diff[..., 0] * db[..., 1] - diff[..., 1] * db[..., 0]
    u = diff[..., 0] * da[..., 1] - diff[..., 1] * da[..., 0]
    ok = torch.abs(denom) > 1e-12
    safe = torch.where(ok, denom, 1.0)
    t, u = t / safe, u / safe
    valid = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return a0 + t[..., None] * da, valid


def _rect_intersection_area(box_a: torch.Tensor, box_b: torch.Tensor
                            ) -> torch.Tensor:
    """Intersection area of rotated rects [x, z, l, w, ry], (..., 5) each
    (broadcast against each other)."""
    box_a, box_b = torch.broadcast_tensors(box_a, box_b)
    qa, qb = _rect_corners_xz(box_a), _rect_corners_xz(box_b)
    inter_pts, inter_valid = _edge_intersections(qa, qb)
    pts = torch.cat([qa, qb, inter_pts], dim=-2)              # (..., 24, 2)
    mask = torch.cat([_point_in_quad(qa, qb), _point_in_quad(qb, qa),
                      inter_valid], dim=-1)
    return _polygon_area(pts, mask)


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                       ) -> torch.Tensor:
    """Pairwise rotated-rect IoU in the BEV (xz) plane: boxes (N, 5) and
    (M, 5) [x, z, l, w, ry] -> (N, M)."""
    inter = _rect_intersection_area(boxes_a[:, None], boxes_b[None, :])
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       0.0)


def iou_3d_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise 3D IoU of box_3d (N, 7) x (M, 7): the y intervals' overlap
    times the rotated footprints' (reference three_d_iou,
    evaluation.py:44); a box spans y in [y - h, y] (y down)."""
    cols = [0, 2, 3, 4, 6]
    inter_2d = _rect_intersection_area(boxes_a[:, None, cols],
                                       boxes_b[None, :, cols])
    top_a = (boxes_a[:, 1] - boxes_a[:, 5])[:, None]
    bot_a = boxes_a[:, 1][:, None]
    top_b = (boxes_b[:, 1] - boxes_b[:, 5])[None, :]
    bot_b = boxes_b[:, 1][None, :]
    h_overlap = torch.clamp(torch.minimum(bot_a, bot_b)
                            - torch.maximum(top_a, top_b), min=0.0)
    inter_vol = inter_2d * h_overlap
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    union = vol_a + vol_b - inter_vol
    return torch.where(union > 0,
                       inter_vol / torch.where(union > 0, union, 1.0), 0.0)
