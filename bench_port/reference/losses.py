"""Loss functions (PyTorch port of dodt_tpu/ops/losses.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """Per-row smooth L1 summed over the code axis, scaled by weight:
    pred/target (..., D), weight (...) -> (...)."""
    abs_diff = torch.abs(pred - target)
    elem = torch.where(abs_diff < 1.0, 0.5 * abs_diff * abs_diff,
                       abs_diff - 0.5)
    return elem.sum(-1) * weight


def weighted_softmax(logits: torch.Tensor, onehot: torch.Tensor,
                     weight) -> torch.Tensor:
    """Sum over rows of softmax cross-entropy, times a scalar weight."""
    ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    return ce.sum() * weight


def weighted_sigmoid(logits: torch.Tensor, targets: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Sum of sigmoid cross-entropy times weights."""
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-torch.abs(logits))))
    return (ce * weights).sum()


def weighted_l2_localization(pred: torch.Tensor, target: torch.Tensor,
                             weight: torch.Tensor) -> torch.Tensor:
    """0.5 * ||w * (pred - target)||^2, summed."""
    weighted_diff = (pred - target) * weight[..., None]
    return (0.5 * weighted_diff * weighted_diff).sum()


def label_smoothing_onehot(labels: torch.Tensor, num_classes: int,
                           epsilon: float = 0.001) -> torch.Tensor:
    """(1 - eps) * onehot + eps / K."""
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    return onehot * (1.0 - epsilon) + epsilon / num_classes
