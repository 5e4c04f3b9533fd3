"""Windowed bilinear crop-and-resize for metric-bounded BEV maps
(kernel B2).

Counterpart of dodt_tpu/ops/roi_pallas.py (``crop_and_resize_window``):
BEV proposals are metric boxes of bounded size, so every crop reads a
static WIN x WIN window of the map. The window origin is floored to 8 px
in y and to ``ax = 128 // gcd(C, 128)`` px in x (the TPU kernel's
alignment), and window-relative sample coords are clamped to
[0, WIN - 1]: exact against the gather path for ROIs spanning
<= WIN - 10 px, edge-clamped beyond, exactly as on the TPU. Every tap is
the map's value rounded to bf16 (the JAX kernel casts f32 maps to bf16)
and the crops are bf16.

The CUDA kernel (``csrc/roi_window.cu``) reads f32 or bf16 maps as they
are, rounds each tap to bf16 in registers, and samples the four taps of
every output directly from the window in one launch for a batch of
maps; ``crop_and_resize_window_plain`` is its PyTorch twin (it casts
the map to bf16 first, the same values). CPU tensors take
the twin, CUDA tensors the kernel, anything else raises. The kernel is
eval-only, as in the JAX package (roi_pallas.py has no VJP): the CUDA
route raises when a gradient is required.
"""
from __future__ import annotations

import ctypes
import math

import torch

from dodt_tpu_torch.ops import _cuda
from dodt_tpu_torch.ops.roi import sample_grid

_KERNEL = _cuda.CudaKernel("dodt_roi_window", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 10)
MAX_CROP = 32        # csrc/roi_window.cu MAX_S
# the map dtypes the kernel reads: (its code in csrc/roi_window.cu, bytes)
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 2)}


def _x_align(c: int) -> int:
    return 128 // math.gcd(c, 128)


def window_applies(h: int, w: int, c: int, crop_size: int,
                   window: int) -> bool:
    """Whether an (H, W, C) map takes the window form: the window fits
    in the map and the x alignment leaves it slack for the crop."""
    return (window > 0 and h >= window and w >= window
            and _x_align(c) < window - crop_size)


def _check_geometry(h: int, w: int, c: int, crop_size: int, window: int):
    if not window_applies(h, w, c, crop_size, window):
        raise ValueError(f"map {(h, w, c)} has no {window}-px window with "
                         f"{_x_align(c)}-px x alignment for {crop_size}-px "
                         "crops")
    return _x_align(c)


def _window_coords(map_shape, boxes_norm: torch.Tensor, crop_size: int,
                   window: int):
    """Per-ROI window origins (oy, ox) and unclamped window-relative
    sample coords (ys_rel, xs_rel), each (M*N, ...). The y origin is
    clamped to [0, H - WIN] and THEN floored to 8 px, as on the TPU: when
    (H - WIN) % 8 != 0, the bottom rows lie outside every window."""
    m, h, w, c = map_shape
    ax = _check_geometry(h, w, c, crop_size, window)
    bx = boxes_norm.reshape(-1, 4).to(torch.float32)
    ys = sample_grid(bx, h, bx[:, 0], bx[:, 2], crop_size)   # (M*N, S)
    xs = sample_grid(bx, w, bx[:, 1], bx[:, 3], crop_size)
    oy = torch.clamp(torch.floor(ys.amin(1)).to(torch.int64), 0, h - window)
    oy = (oy >> 3) << 3
    ox = torch.clamp(torch.floor(xs.amin(1)).to(torch.int64), 0, w - window)
    ox = (ox // ax) * ax
    return oy, ox, ys - oy[:, None].float(), xs - ox[:, None].float()


def window_fits(map_shape, boxes_norm: torch.Tensor, crop_size: int,
                window: int = 64) -> torch.Tensor:
    """(M, N) mask of the ROIs whose every sample lies inside its window:
    for those the window crop is exactly the gather crop."""
    _, _, ys_rel, xs_rel = _window_coords(map_shape, boxes_norm, crop_size,
                                          window)
    fits = (ys_rel.amax(1) <= window - 1) & (xs_rel.amax(1) <= window - 1)
    return fits.reshape(boxes_norm.shape[:-1])


def crop_and_resize_window_plain(images: torch.Tensor,
                                 boxes_norm: torch.Tensor, crop_size: int,
                                 window: int = 64) -> torch.Tensor:
    """Twin of the kernel: images (M, H, W, C), boxes (M, N, 4)
    normalised [y1, x1, y2, x2] -> (M, N, S, S, C) bf16."""
    m, h, w, c = images.shape
    n, s = boxes_norm.shape[1], crop_size
    img = images.to(torch.bfloat16)
    oy, ox, ys_rel, xs_rel = _window_coords(images.shape, boxes_norm, s,
                                            window)
    ys_rel = torch.clamp(ys_rel, 0.0, window - 1.0)
    xs_rel = torch.clamp(xs_rel, 0.0, window - 1.0)
    iy0f, ix0f = torch.floor(ys_rel), torch.floor(xs_rel)
    fy = (ys_rel - iy0f)[:, :, None, None]
    fx = (xs_rel - ix0f)[:, None, :, None]
    iy0, ix0 = iy0f.to(torch.int64), ix0f.to(torch.int64)
    gy0 = oy[:, None] + iy0
    gy1 = oy[:, None] + torch.clamp(iy0 + 1, max=window - 1)
    gx0 = ox[:, None] + ix0
    gx1 = ox[:, None] + torch.clamp(ix0 + 1, max=window - 1)
    mi = torch.arange(m, device=images.device).repeat_interleave(n)
    mi = mi[:, None, None]

    def tap(gy, gx):                                         # (M*N, S, S, C)
        return img[mi, gy[:, :, None], gx[:, None, :]].float()

    tl, tr = tap(gy0, gx0), tap(gy0, gx1)
    bl, br = tap(gy1, gx0), tap(gy1, gx1)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    out = (top + (bot - top) * fy).to(torch.bfloat16)
    return out.reshape(m, n, s, s, c)


def vector_width(dtype: torch.dtype, c: int, data_ptr: int) -> int:
    """Channels per load of the kernel: a 16-byte vector (4 f32 or 8 bf16
    channels) where C is a multiple of it and the map 16-byte aligned,
    else 1 (the scalar instance, any C)."""
    vec = 16 // _DTYPES[dtype][1]
    return vec if c % vec == 0 and data_ptr % 16 == 0 else 1


def crop_and_resize_window_cuda(images: torch.Tensor,
                                boxes_norm: torch.Tensor, crop_size: int,
                                window: int = 64) -> torch.Tensor:
    """The kernel: images (M, H, W, C) f32 or bf16, read in their own
    dtype; boxes (M, N, 4) -> (M, N, S, S, C) bf16."""
    images = images.contiguous()
    boxes_norm = boxes_norm.to(torch.float32).contiguous()
    m, h, w, c = images.shape
    n = boxes_norm.shape[1]
    if images.dtype not in _DTYPES or images.device.type != "cuda":
        raise ValueError(f"images: expected an f32 or bf16 CUDA tensor, got "
                         f"{images.dtype} on {images.device}")
    if boxes_norm.shape != (m, n, 4) or boxes_norm.device != images.device:
        raise ValueError(f"boxes {tuple(boxes_norm.shape)} on "
                         f"{boxes_norm.device} do not match {m} maps on "
                         f"{images.device}")
    if not 0 < crop_size <= MAX_CROP:
        raise ValueError(f"crop_size must be in [1, {MAX_CROP}]")
    ax = _check_geometry(h, w, c, crop_size, window)
    out = torch.empty((m, n, crop_size, crop_size, c), dtype=torch.bfloat16,
                      device=images.device)
    if n:
        _KERNEL(images.device, _cuda.ptr(images), _cuda.ptr(boxes_norm),
                _cuda.ptr(out), m, h, w, c, n, crop_size, window, ax,
                _DTYPES[images.dtype][0],
                vector_width(images.dtype, c, images.data_ptr()))
    return out


def crop_and_resize_window(images: torch.Tensor, boxes_norm: torch.Tensor,
                           crop_size: int, window: int = 64
                           ) -> torch.Tensor:
    """Windowed crop-and-resize of (M, H, W, C) maps by (M, N, 4) boxes
    -> (M, N, S, S, C) bf16; an unbatched (H, W, C) map with (N, 4)
    boxes gives (N, S, S, C)."""
    if images.dim() == 3:
        return crop_and_resize_window(images[None], boxes_norm[None],
                                      crop_size, window)[0]
    if images.device.type == "cpu":
        return crop_and_resize_window_plain(images, boxes_norm, crop_size,
                                            window)
    if images.device.type != "cuda":
        raise ValueError(f"crop_and_resize_window: no kernel for device "
                         f"{images.device}")
    if torch.is_grad_enabled() and (images.requires_grad
                                    or boxes_norm.requires_grad):
        # neither package defines this kernel's gradient: training
        # crops take the gather form (bev_crop_fn)
        raise RuntimeError("crop_and_resize_window has no gradient; "
                           "use the gather crop (ops/roi.py) in training")
    return crop_and_resize_window_cuda(images, boxes_norm, crop_size, window)
