"""Weights made from the seed on the device, in a few large calls, and
handed alike to the program and to the reference.

The distribution is the port's ``init_params`` (Flax's initialisers):
every weight of two or more axes LeCun-normal truncated at two sigma
(fan-in over every axis but the first), biases zero, GroupNorm scales
one; then the weights the configuration names under ``output_scales``
(the regression output layers) are scaled, so that proposals stay near
their anchors and detections near their proposals, as a trained
detector's do. The uniforms come from one ``torch.Generator`` on the
device, in one call for all weights."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

TRUNC_STD = .87962566103423978        # the std of a unit normal cut at 2


def make_weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int,
                 device: torch.device, output_scales: Dict[str, float]
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for (name, shape) pairs."""
    shapes = list(shapes)
    drawn = [(n, s) for n, s in shapes if len(s) >= 2]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
    hi = 0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    out, at = {}, 0
    for name, shape in shapes:
        if len(shape) >= 2:
            n = math.prod(shape)
            std = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD
            out[name] = (z[at:at + n] * std).reshape(shape)
            at += n
        elif ".GroupNorm_" in name and name.endswith(".weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    for name, scale in output_scales.items():
        out[name] = out[name] * scale
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``weights`` into every parameter of ``model``; a name missing
    on either side raises."""
    names = dict(model.named_parameters())
    if names.keys() != weights.keys():
        raise KeyError(f"weights and model differ: "
                       f"{sorted(names.keys() ^ weights.keys())[:8]}")
    for name, p in names.items():
        p.copy_(weights[name])
