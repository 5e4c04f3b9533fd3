"""Bilinear resize of NHWC maps, the counterpart of
``jax.image.resize(x, shape, method="bilinear")`` as the JAX package
calls it (dodt_tpu/models/dt_avod.py ``_resize_to``, the plain VGG
tower's upsample in dodt_tpu/models/backbone.py), deterministic on
every device.

Each spatial axis is a fixed linear map W (n_out, n_in) with JAX's own
weights (``jax._src.image.scale.compute_weight_mat``: half-pixel
centres, the triangle kernel, widened by the ratio when downsampling,
each output's weights normalised to sum 1, which clamps the edges, and
outputs whose sample falls off the map zero). At the model's upsampling
ratios that is two taps per output, as ``F.interpolate(bilinear,
align_corners=False)`` computes them.

The forward gathers, for each output row (then column), the input rows
its row of W names and sums them with their weights; the backward is
W^T applied the same way, each input row gathering the fixed set of
output rows it feeds. Both are a loop over a few taps of
``index_select`` and multiply-adds in one fixed order, in float32 (or
the input's wider type), rounded once to the input's dtype: no
``index_add``, ``scatter_add`` or atomics, so a gradient is the same bit
for bit from run to run (``F.interpolate``'s CUDA backward sums with
atomics: ROADMAP C19). The tap tables are built once per (n_in, n_out,
device, dtype).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """JAX's bilinear weights for one axis as an (n_out, n_in) float32
    matrix (compute_weight_mat with antialias, in float32 as JAX computes
    them)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def _taps(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(index, weight), each (rows, K): row r of ``w`` as its non-zero
    columns in ascending order, padded with weight 0 on column 0."""
    nz = w != 0
    k = max(int(nz.sum(1).max()), 1)
    idx = np.zeros((w.shape[0], k), np.int64)
    wt = np.zeros((w.shape[0], k), np.float32)
    for r in range(w.shape[0]):
        cols = np.flatnonzero(nz[r])
        idx[r, :cols.size] = cols
        wt[r, :cols.size] = w[r, cols]
    return idx, wt


@functools.lru_cache(maxsize=64)
def _axis_tables(n_in: int, n_out: int, device: torch.device,
                 dtype: torch.dtype):
    """The forward's and the backward's taps of one axis on ``device``:
    ((index, weight) of W, (index, weight) of W^T)."""
    w = weight_matrix(n_in, n_out)
    return tuple(
        (torch.as_tensor(i, device=device),
         torch.as_tensor(t, device=device).to(dtype))
        for i, t in (_taps(w), _taps(w.T)))


def _gather_sum(x: torch.Tensor, dim: int, idx: torch.Tensor,
                wt: torch.Tensor) -> torch.Tensor:
    """out[.., r, ..] = sum_k wt[r, k] * x[.., idx[r, k], ..] along
    ``dim``, the taps summed in order."""
    shape = [1] * x.dim()
    shape[dim] = idx.shape[0]
    out = x.index_select(dim, idx[:, 0]) * wt[:, 0].view(shape)
    for k in range(1, idx.shape[1]):
        out = out + x.index_select(dim, idx[:, k]) * wt[:, k].view(shape)
    return out


class _Resample(torch.autograd.Function):
    """x (B, H, W, C) through the tap tables of axes 1 and 2; the
    backward is the same op with the transposed tables."""

    @staticmethod
    def forward(ctx, x, taps, taps_t):
        ctx.tables = (taps, taps_t)
        y = x.to(taps[0][1].dtype)
        for dim, (idx, wt) in zip((1, 2), taps):
            y = _gather_sum(y, dim, idx, wt)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        taps, taps_t = ctx.tables
        return _Resample.apply(grad, taps_t, taps), None, None


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (B, H, W, C), "bilinear") of an NHWC map
    (B, h, w, C), in x's dtype (computed in float32 or x's wider
    type); differentiable, with a deterministic backward."""
    h_out, w_out = (int(v) for v in hw)
    ct = torch.promote_types(x.dtype, torch.float32)
    taps, taps_t = zip(*(_axis_tables(n_in, n_out, x.device, ct)
                         for n_in, n_out in ((x.shape[1], h_out),
                                             (x.shape[2], w_out))))
    return _Resample.apply(x, taps, taps_t)
