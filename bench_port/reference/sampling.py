"""Mini-batch target assignment and balanced sampling on the device
(PyTorch port of dodt_tpu/ops/sampling.py), batched over leading axes.

Every random choice takes its uniform draws as a tensor ``u`` of shape
(..., 2, N): ``u[..., 0, :]`` ranks the positives, ``u[..., 1, :]`` the
negatives (the JAX ``balanced_sample`` draws them from its two split
keys). Training draws them from an explicit ``torch.Generator``; the
tests inject the JAX package's draws, so both packages pick the same
anchors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import anchor_to_offset
from .iou import aligned_iou_matrix


class AnchorTargets(NamedTuple):
    max_iou: torch.Tensor      # (..., N) best IoU with any valid GT
    offsets: torch.Tensor      # (..., N, 6) offsets to the best GT
    class_idx: torch.Tensor    # (..., N) int64, 0 = background
    gt_index: torch.Tensor     # (..., N) int64 best GT row


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., G, D) or (..., G) gathered at idx (..., N) along G."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(
        idx.shape + x.shape[-1:]))


def assign_targets(anchors_bev: torch.Tensor, anchors: torch.Tensor,
                   gt_bev: torch.Tensor, gt_anchors: torch.Tensor,
                   gt_classes: torch.Tensor, gt_valid: torch.Tensor
                   ) -> AnchorTargets:
    """Best-GT assignment per anchor: anchors_bev (..., N, 4), anchors
    (..., N, 6), gt_bev (..., G, 4), gt_anchors (..., G, 6), gt_classes
    and gt_valid (..., G). Leading axes broadcast."""
    iou = aligned_iou_matrix(anchors_bev, gt_bev)              # (..., N, G)
    iou = torch.where(gt_valid[..., None, :], iou, -1.0)
    max_iou, gt_index = iou.max(dim=-1)    # first maximum, as jnp.argmax
    max_iou = torch.clamp(max_iou, min=0.0)
    lead = gt_index.shape[:-1]
    best_gt = _take_rows(gt_anchors.expand(lead + gt_anchors.shape[-2:]),
                         gt_index)
    # guard against log(0) on padded GT rows
    ok = best_gt[..., 3:6].amin(-1, keepdim=True) > 0
    safe_gt = torch.where(ok, best_gt, torch.cat(
        [best_gt[..., 0:3], torch.ones_like(best_gt[..., 3:6])], dim=-1))
    offsets = anchor_to_offset(anchors.expand(safe_gt.shape), safe_gt)
    matched = max_iou > 0.0
    cls = _take_rows(gt_classes.expand(lead + gt_classes.shape[-1:]),
                     gt_index)
    return AnchorTargets(
        max_iou=max_iou,
        offsets=torch.where(matched[..., None], offsets, 0.0),
        class_idx=torch.where(matched, cls.long(), 0),
        gt_index=gt_index)


def _rank_mask(u: torch.Tensor, mask: torch.Tensor, count) -> torch.Tensor:
    """``count`` True entries of ``mask`` (..., N), those with the largest
    draws ``u`` (ties by index, as the stable jnp.argsort)."""
    n = mask.shape[-1]
    priority = torch.where(mask, u, -1.0)
    order = torch.argsort(-priority, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=mask.device).expand_as(order))
    if isinstance(count, torch.Tensor):
        count = count[..., None]
    return mask & (rank < count)


def balanced_sample(u: torch.Tensor, pos_mask: torch.Tensor,
                    eligible_mask: torch.Tensor, size: int,
                    positive_fraction: float = 0.5):
    """At most ``size * positive_fraction`` random positives, the rest
    random negatives from ``eligible & ~pos``. Returns (sampled, pos
    sampled) boolean masks (..., N)."""
    neg_mask = eligible_mask & ~pos_mask
    max_pos = int(size * positive_fraction)
    num_pos = torch.clamp(pos_mask.sum(-1), max=max_pos)
    pos_sel = _rank_mask(u[..., 0, :], pos_mask, num_pos)
    neg_sel = _rank_mask(u[..., 1, :], neg_mask, size - num_pos)
    return pos_sel | neg_sel, pos_sel


def sample_mini_batch(u: torch.Tensor, max_ious: torch.Tensor, size: int,
                      neg_range, pos_range):
    """Anchors below neg_hi are negatives, above pos_lo positives, the
    band between is left out. With neg_lo > 0 negatives need IoU >=
    neg_lo, unless nothing would be eligible at all: then every
    background anchor is."""
    neg_lo, neg_hi = neg_range
    pos_lo, _ = pos_range
    bkg_and_neg = max_ious < neg_hi
    pos = max_ious > pos_lo
    indicator = pos | bkg_and_neg
    if neg_lo > 0.0:
        neg = bkg_and_neg & (max_ious >= neg_lo)
        any_valid = indicator.any(-1, keepdim=True)
        indicator = torch.where(any_valid, pos | neg, bkg_and_neg)
    return balanced_sample(u, pos, indicator, size)
