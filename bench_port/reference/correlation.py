"""The reference's correlation: the plain twin of kernel B3 from
``dodt_tpu_torch/ops/correlation.py`` (``corr_bottleneck_plain`` on the
blur's grid, the grid B3 and the JAX model read), one displacement at a
time in float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def disp_grid(max_displacement: int, stride_2: int):
    radius = max_displacement // stride_2
    return radius, 2 * radius + 1


def grid_origin(max_displacement: int, stride_2: int) -> int:
    """How many pixels the blur's displacement grid sits up and left of
    the correlation's: max_displacement - r * stride_2, in [0,
    stride_2)."""
    return max_displacement % stride_2


def corr_bottleneck(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor,
                    max_displacement: int, stride_2: int = 1
                    ) -> torch.Tensor:
    """a, b (B, H, W, C); weights (D^2, Cb) -> (B, Cb, H, W): the mean
    over channels of A times B displaced by (ky - r) * stride_2 - origin
    rows and (kx - r) * stride_2 - origin columns, contracted with the
    weights, origin = ``grid_origin``."""
    a, b, weights = (t.to(torch.float32) for t in (a, b, weights))
    origin = grid_origin(max_displacement, stride_2)
    nb, h, w, c = a.shape
    radius, d = disp_grid(max_displacement, stride_2)
    lo = radius * stride_2 + origin
    hi = radius * stride_2 - origin
    b_pad = F.pad(b, (0, 0, lo, hi, lo, hi))
    out = torch.zeros((nb, weights.shape[1], h, w), dtype=a.dtype,
                      device=a.device)
    for k in range(d * d):
        dy = k // d * stride_2
        dx = k % d * stride_2
        corr = (a * b_pad[:, dy:dy + h, dx:dx + w]).sum(-1) / c
        out = out + weights[k][None, :, None, None] * corr[:, None]
    return out
