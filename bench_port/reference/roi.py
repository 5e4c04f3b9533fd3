"""Bilinear crop-and-resize (PyTorch port of dodt_tpu/ops/roi.py).

Half-pixel convention: sample coordinate = norm * dim - 0.5, clamped to
the map, so the sample lattice of the regular anchor grid is periodic
(ops/dense_rpn.py). Two forms of the same function:

* gather: four taps per sample, blended in the map's dtype;
* matmul: bilinear sampling is separable, so the crop is
  ``Ry @ F @ Cx^T`` with hat-function interpolation matrices.

``auto_method`` makes the same static choice as the JAX package so the
two packages agree to rounding on every shape.

Gradients (w.r.t. the map and the boxes) are autograd's. The JAX
package's training methods ``auto_train`` / ``gather_mmbwd`` keep the
gather forward and swap in the matmul form's VJP, because TPU
scatter-adds serialize; the two VJPs are the same function's (the same
sample lattice and clamping), equal up to f32 summation order. On the
card the gather's own backward (an index-add) is the plain route, so
the port maps every training method onto its forward form with
autograd: ``gather_mmbwd`` is ``gather``, ``auto_train`` is ``auto``.
There is no proposal chunking to port: autograd's index-add backward
never materialises the matmul form's (N, S, W, C) intermediate.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _unit_grid(s: int, device: torch.device) -> torch.Tensor:
    """k / (s - 1) for k < s in f32, divided on the CPU and kept per
    device. A CUDA tensor divided by a Python number is multiplied by the
    number's rounded reciprocal, one ulp off the quotient for some k
    (s = 7 among them); numpy, the CPU and kernel B2 compute the
    quotient. Jitted XLA multiplies by the reciprocal and contracts the
    crop's multiply-adds into FMAs, so its sample coordinates differ by
    an ulp either way, and the bilinear crop is continuous in them."""
    return (torch.arange(s, dtype=torch.float32) / (s - 1)).to(device)


def sample_grid(boxes_norm: torch.Tensor, dim_px: int, lo: torch.Tensor,
                hi: torch.Tensor, crop_size: int) -> torch.Tensor:
    """Pixel sample coordinates along one axis, (N, S), clamped."""
    s = crop_size
    if s > 1:
        grid = _unit_grid(s, boxes_norm.device)
        t = lo[:, None] + (hi - lo)[:, None] * grid
    else:
        t = ((lo + hi) / 2.0)[:, None]
    return torch.clamp(t * dim_px - 0.5, 0.0, dim_px - 1)


def interp_matrix(coords: torch.Tensor, dim_px: int) -> torch.Tensor:
    """Hat-function interpolation matrix (N, S, dim_px) of clamped
    coords (N, S): weight 1 - frac at floor, frac at floor + 1."""
    r = torch.arange(dim_px, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - r), min=0.0)


def crop_and_resize_matmul(image: torch.Tensor, boxes_norm: torch.Tensor,
                           crop_size: int) -> torch.Tensor:
    h, w, c = image.shape
    n = boxes_norm.shape[0]
    s = crop_size
    ys = sample_grid(boxes_norm, h, boxes_norm[:, 0], boxes_norm[:, 2], s)
    xs = sample_grid(boxes_norm, w, boxes_norm[:, 1], boxes_norm[:, 3], s)
    ry = interp_matrix(ys, h).to(image.dtype)            # (N, S, H)
    cx = interp_matrix(xs, w).to(image.dtype)            # (N, S, W)
    rowred = (ry.reshape(n * s, h) @ image.reshape(h, w * c)
              ).reshape(n, s, w, c)
    return torch.einsum("nywc,nxw->nyxc", rowred, cx)


def auto_method(num_boxes: int, crop_size: int, image_shape,
                itemsize: int) -> str:
    """Matmul form for thin-channel maps with a large crop batch and a
    bounded (N, S, W, C) intermediate, gather form otherwise (the JAX
    package's static dispatch, roi.py:98-120)."""
    _, w_, c_ = image_shape
    ns = num_boxes * crop_size
    rowred_bytes = ns * w_ * c_ * itemsize
    return ("matmul" if 256 <= ns <= 65536 and c_ <= 2
            and rowred_bytes <= 128 * 1024 * 1024 else "gather")


def crop_and_resize_gather(image: torch.Tensor, boxes_norm: torch.Tensor,
                           crop_size: int) -> torch.Tensor:
    h, w, c = image.shape
    ys = sample_grid(boxes_norm, h, boxes_norm[:, 0], boxes_norm[:, 2],
                     crop_size)
    xs = sample_grid(boxes_norm, w, boxes_norm[:, 1], boxes_norm[:, 3],
                     crop_size)
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    # f32 fractions: a bf16 map blends in f32, as jnp type promotion does
    y_frac = (ys - y0f)[:, :, None, None]                   # (N, S, 1, 1)
    x_frac = (xs - x0f)[:, None, :, None]                   # (N, 1, S, 1)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)

    def gather(yi, xi):
        return image[yi[:, :, None], xi[:, None, :]]        # (N, S, S, C)

    tl, tr = gather(y0, x0), gather(y0, x1)
    bl, br = gather(y1, x0), gather(y1, x1)
    top = tl + (tr - tl) * x_frac
    bot = bl + (br - bl) * x_frac
    return top + (bot - top) * y_frac


# the JAX training methods -> the forward form they share
TRAIN_METHODS = {"auto_train": "auto", "gather_mmbwd": "gather"}


def crop_and_resize(image: torch.Tensor, boxes_norm: torch.Tensor,
                    crop_size: int, method: str = "auto") -> torch.Tensor:
    """(H, W, C) map, (N, 4) normalised [y1, x1, y2, x2] boxes ->
    (N, S, S, C) crops. method: "auto" | "gather" | "matmul", or the
    JAX training names "auto_train" | "gather_mmbwd" (the same forms
    with autograd's VJP; see the module docstring)."""
    method = TRAIN_METHODS.get(method, method)
    if method == "auto":
        method = auto_method(boxes_norm.shape[0], crop_size, image.shape,
                             image.element_size())
    if method == "matmul":
        return crop_and_resize_matmul(image, boxes_norm, crop_size)
    if method == "gather":
        return crop_and_resize_gather(image, boxes_norm, crop_size)
    raise ValueError(f"unknown crop method {method!r}")
