"""FlowNet correlation: the raw volume (kernel B4) and the volume fused
with its 1x1 bottleneck (kernel B3).

  corr[d, y, x] = (1 / C) * sum_c A[y, x, c] *
                  B_pad[y + pad + dy_d, x + pad + dx_d, c]
  out[k, y, x] = sum_d w[d, k] * corr[d, y, x]
  over displacements d = ky * D + kx, dy = (ky - r) * stride_2,
  dx = (kx - r) * stride_2, r = max_displacement // stride_2, D = 2r + 1,
  pad = max_displacement, zero padding outside the map.

Two displacement grids. The correlation's (``correlation_xla``, the
raw volume, B4) is centred: the offsets above. The blur's (JAX's
``corr_bottleneck_blur``, the form the JAX model computes, and its
Pallas kernel ``corr_bottleneck_pallas``) pads B by max_displacement
before the map and (D - 1) stride_2 - max_displacement after it, so its
offsets are (ky - r) * stride_2 - o with o = ``grid_origin`` =
max_displacement - r * stride_2: the same grid wherever
max_displacement % stride_2 == 0 (o = 0, every preset), one moved by o
pixels up and left otherwise. B3 and the model's ``corr_bottleneck``
take the blur's grid; both twins take either (``origin``). JAX's
``correlation_pallas_cf`` reads the blur's grid too, so JAX's public
``correlation`` moves by o between the TPU and other backends; the
port's follows it between the card (B4, the Pallas kernel's grid) and
the CPU (the twin on ``correlation_xla``'s).

Counterpart of dodt_tpu/ops/correlation.py. ``correlation_cf`` /
``correlation`` replace the ``correlation_pallas_cf`` route of the
public ops (CUDA kernel ``csrc/correlation_cf.cu``; no model calls
them). ``corr_bottleneck`` replaces ``corr_bottleneck_pallas``; its CUDA
kernel (``csrc/correlation.cu``) contracts the correlation with the
weights on chip, so the D^2-channel volume never reaches device memory.
``corr_bottleneck_blur`` is the form the JAX model computes (a
depthwise D x D conv of B and a multiply-reduce with A); on the card
it is B3's backward (``corr_bottleneck_vjp``). Each kernel has a
PyTorch twin (``*_plain``). CPU tensors take the twin, CUDA tensors the
kernel, anything else raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dodt_tpu_torch.ops import _cuda

_KERNEL = _cuda.CudaKernel("dodt_corr_bottleneck", [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)
_CF_KERNEL = _cuda.CudaKernel("dodt_correlation_cf", [
    ctypes.c_void_p] * 3 + [ctypes.c_int] * 9)
MAX_CB = 4                   # csrc/correlation.cu
# csrc/correlation_cf.cu: displacements per axis, output columns per
# block, (D bucket, output rows per thread) of its instances, and the
# shared memory a block may take
MAX_D = 21
CF_COLS = 32
CF_TILINGS = ((5, 8), (11, 5), (21, 2))
CF_MAX_SMEM = 227 * 1024


class CfGeometry(NamedTuple):
    """B4's tiling: D, the instance's D bucket and output rows per thread
    (a block is rows x CF_COLS pixels and a warp per displacement
    column), the depth of the ring of staged channel slices and its
    dynamic shared memory in bytes (each stage the haloed B tile and the
    A tile, 4 f32 channels a pixel)."""
    d: int
    dmax: int
    rows: int
    stages: int
    smem: int


def cf_geometry(max_displacement: int, stride_2: int) -> CfGeometry:
    """The tiling csrc/correlation_cf.cu launches: the smallest D bucket
    that holds D, so that a thread keeps rows x D <= 55 accumulators,
    and a four-stage ring where it fits in shared memory, else two
    stages; a ValueError where two do not fit."""
    _, d = disp_grid(max_displacement, stride_2)
    if d > MAX_D:
        raise ValueError(f"correlation_cf kernel takes D <= {MAX_D}, got "
                         f"{d} (max_displacement {max_displacement}, "
                         f"stride_2 {stride_2})")
    dmax, rows = next(t for t in CF_TILINGS if d <= t[0])
    span = (d - 1) * stride_2
    stage = (rows + span) * (CF_COLS + span) + rows * CF_COLS
    stages = 4 if 4 * stage * 16 <= CF_MAX_SMEM else 2
    if stages * stage * 16 > CF_MAX_SMEM:
        raise ValueError(f"max_displacement {max_displacement}, stride_2 "
                         f"{stride_2}: the haloed tiles need "
                         f"{stages * stage * 16} B of shared memory, more "
                         f"than the card's {CF_MAX_SMEM}")
    return CfGeometry(d, dmax, rows, stages, stages * stage * 16)


def disp_grid(max_displacement: int, stride_2: int):
    radius = max_displacement // stride_2
    return radius, 2 * radius + 1


def grid_origin(max_displacement: int, stride_2: int) -> int:
    """How many pixels the blur's displacement grid sits up and left of
    the correlation's: max_displacement - r * stride_2, in [0,
    stride_2)."""
    return max_displacement % stride_2


def corr_bottleneck_plain(a: torch.Tensor, b: torch.Tensor,
                          weights: torch.Tensor, max_displacement: int,
                          stride_2: int = 1, origin: int = 0
                          ) -> torch.Tensor:
    """Twin: a, b (B, H, W, C); weights (D^2, Cb) -> (B, Cb, H, W), one
    displacement at a time, B read at (ky - r) * stride_2 - origin rows
    and (kx - r) * stride_2 - origin columns: origin 0 is the
    correlation's grid (JAX's ``corr_bottleneck_xla``), ``grid_origin``
    the blur's (B3's)."""
    if not 0 <= origin < stride_2:
        raise ValueError(f"origin {origin}: need 0 <= origin < stride_2 "
                         f"({stride_2})")
    nb, h, w, c = a.shape
    radius, d = disp_grid(max_displacement, stride_2)
    lo = radius * stride_2 + origin
    hi = radius * stride_2 - origin
    # b_pad[:, y + ky s2, x + kx s2] is B at the displacement (ky, kx)
    b_pad = F.pad(b, (0, 0, lo, hi, lo, hi))
    out = torch.zeros((nb, weights.shape[1], h, w), dtype=a.dtype,
                      device=a.device)
    for k in range(d * d):
        dy = k // d * stride_2
        dx = k % d * stride_2
        corr = (a * b_pad[:, dy:dy + h, dx:dx + w]).sum(-1) / c
        out += weights[k][None, :, None, None] * corr[:, None]
    return out


def corr_bottleneck_cuda(a: torch.Tensor, b: torch.Tensor,
                         weights: torch.Tensor, max_displacement: int,
                         stride_2: int = 1) -> torch.Tensor:
    """The kernel: a, b (B, H, W, C) f32, C % 8 == 0; weights (D^2, Cb)
    f32, Cb <= 4 -> (B, Cb, H, W) f32, on the blur's grid (the Pallas
    kernel's: the twin at ``grid_origin``). Any max_displacement and
    stride_2 whose haloed tiles fit the card's 227 KB of shared memory
    (r s2 up to about 30)."""
    _cuda.check_cuda_tensor("a", a, torch.float32, 4)
    _cuda.check_cuda_tensor("b", b, torch.float32, 4)
    _cuda.check_cuda_tensor("weights", weights, torch.float32, 2, align=4)
    nb, h, w, c = a.shape
    _, d = disp_grid(max_displacement, stride_2)
    cb = weights.shape[1]
    if b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    if c % 8:
        raise ValueError(f"correlation kernel needs C % 8 == 0, got {c}")
    if weights.shape[0] != d * d or not 0 < cb <= MAX_CB:
        raise ValueError(f"weights {tuple(weights.shape)}: need "
                         f"({d * d}, Cb) with Cb <= {MAX_CB}")
    if not (a.device == b.device == weights.device):
        raise ValueError("a, b and weights must be on one device")
    lib = _cuda.load()
    smem = lib.dodt_corr_bottleneck_smem_bytes(max_displacement, stride_2)
    if smem > lib.dodt_corr_bottleneck_max_smem():
        raise ValueError(f"max_displacement {max_displacement}, stride_2 "
                         f"{stride_2} need {smem} B of shared memory")
    out = torch.empty((nb, cb, h, w), dtype=torch.float32, device=a.device)
    if out.numel():
        _KERNEL(a.device, _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(weights),
                _cuda.ptr(out), nb, h, w, c, max_displacement, stride_2,
                cb)
    return out


def corr_bottleneck_blur(a: torch.Tensor, b: torch.Tensor,
                         weights: torch.Tensor, max_displacement: int,
                         stride_2: int = 1) -> torch.Tensor:
    """The correlation + bottleneck as a blur (dodt_tpu/ops/correlation.py
    ``corr_bottleneck_blur``): out[k] = (1 / C) sum_c A_c * (B_c blurred
    with the D x D kernel w[:, k]), so the D^2-channel volume never
    exists. a, b (B, H, W, C) or (H, W, C); weights (D^2, Cb) ->
    (B, Cb, H, W) or (Cb, H, W); plain PyTorch on any device.

    The blur is one depthwise conv (groups = C, dilation stride_2) of a
    contiguous NCHW copy of B (cuDNN's depthwise conv on the permuted
    channels-last map took 4-5 times as long on an H100:
    probes/b3_blur_forms.py), whose output channel c * Cb + k is
    channel c of B under column k of the weights (JAX's tiled kernel
    order), in B's dtype; the reduce promotes A and the blur as JAX's
    einsum does. B is padded as JAX pads it, max_displacement before
    the map and (D - 1) * stride_2 - max_displacement after it: the
    blur's grid (``grid_origin``), B3's."""
    if a.dim() == 3:
        return corr_bottleneck_blur(a[None], b[None], weights,
                                    max_displacement, stride_2)[0]
    nb, h, w, c = a.shape
    radius, d = disp_grid(max_displacement, stride_2)
    cb = weights.shape[1]
    lo = max_displacement
    hi = (d - 1) * stride_2 - max_displacement
    kern = weights.to(b.dtype).t().reshape(cb, 1, d, d).repeat(c, 1, 1, 1)
    b_pad = F.pad(b.permute(0, 3, 1, 2).contiguous(), (lo, hi, lo, hi))
    bw = F.conv2d(b_pad, kern, dilation=stride_2, groups=c)
    bw = bw.reshape(nb, c, cb, h, w)
    dt = torch.promote_types(a.dtype, bw.dtype)
    return torch.einsum("nchw,nckhw->nkhw", a.permute(0, 3, 1, 2).to(dt),
                        bw.to(dt)) / c


def corr_bottleneck_vjp(a: torch.Tensor, b: torch.Tensor,
                        weights: torch.Tensor, grad: torch.Tensor,
                        max_displacement: int, stride_2: int = 1):
    """B3's backward: the gradients (a, b, weights) of
    ``corr_bottleneck_blur`` recomputed from the saved inputs under the
    output gradient ``grad`` (the JAX custom_vjp's backward through an
    XLA form, dodt_tpu/ops/correlation.py:282-287). It holds B's NCHW
    copy and the blur (B, C x Cb, H, W) as its extra maps."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (a, b, weights)]
        out = corr_bottleneck_blur(*leaves, max_displacement, stride_2)
        return torch.autograd.grad(out, leaves, grad)


class _CorrBottleneck(torch.autograd.Function):
    """The kernel forward on the blur's grid; the backward is
    ``corr_bottleneck_vjp``, the blur's VJP on the same grid, recomputed
    from the saved a, b and weights (there is no backward kernel)."""

    @staticmethod
    def forward(ctx, a, b, weights, max_displacement, stride_2):
        ctx.save_for_backward(a, b, weights)
        ctx.args = (max_displacement, stride_2)
        return corr_bottleneck_cuda(a, b, weights, max_displacement,
                                    stride_2)

    @staticmethod
    def backward(ctx, grad):
        ga, gb, gw = corr_bottleneck_vjp(*ctx.saved_tensors, grad,
                                         *ctx.args)
        return ga, gb, gw, None, None


def corr_bottleneck(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor,
                    max_displacement: int, stride_2: int = 1
                    ) -> torch.Tensor:
    """Fused correlation + 1x1 contraction on the blur's grid (JAX's
    ``corr_bottleneck``, which the JAX model calls), channel-first
    output: (B, H, W, C) pairs -> (B, Cb, H, W); unbatched (H, W, C) ->
    (Cb, H, W). Bias and norm are the caller's. Differentiable w.r.t.
    a, b and the weights on both routes."""
    if a.dim() == 3:
        return corr_bottleneck(a[None], b[None], weights, max_displacement,
                               stride_2)[0]
    if a.device.type == "cpu":
        return corr_bottleneck_plain(a, b, weights, max_displacement,
                                     stride_2,
                                     grid_origin(max_displacement, stride_2))
    if a.device.type != "cuda":
        raise ValueError(f"corr_bottleneck: no kernel for device {a.device}")
    return _CorrBottleneck.apply(
        a.to(torch.float32).contiguous(), b.to(torch.float32).contiguous(),
        weights.to(torch.float32).contiguous(), max_displacement, stride_2)


# ---------------------------------------------------------------- B4

def correlation_cf_plain(a: torch.Tensor, b: torch.Tensor,
                         max_displacement: int, stride_2: int = 1,
                         origin: int = 0) -> torch.Tensor:
    """Twin: a, b (N, H, W, C) -> (N, D^2, H, W) in the input dtype, one
    displacement at a time, B read at (ky - r) * stride_2 - origin rows
    and (kx - r) * stride_2 - origin columns: origin 0 is
    ``correlation_xla``'s grid, ``grid_origin`` the Pallas kernel's
    (B4's); differentiable by autograd."""
    if not 0 <= origin < stride_2:
        raise ValueError(f"origin {origin}: need 0 <= origin < stride_2 "
                         f"({stride_2})")
    _, h, w, c = a.shape
    radius, d = disp_grid(max_displacement, stride_2)
    lo = radius * stride_2 + origin
    hi = radius * stride_2 - origin
    # b_pad[:, y + ky s2, x + kx s2] is B at the displacement (ky, kx)
    b_pad = F.pad(b, (0, 0, lo, hi, lo, hi))
    maps = []
    for k in range(d * d):
        dy = k // d * stride_2
        dx = k % d * stride_2
        maps.append((a * b_pad[:, dy:dy + h, dx:dx + w]).sum(-1) / c)
    return torch.stack(maps, dim=1)


def correlation_cf_cuda(a: torch.Tensor, b: torch.Tensor,
                        max_displacement: int, stride_2: int = 1
                        ) -> torch.Tensor:
    """The kernel: a, b (N, H, W, C) f32, C % 4 == 0 -> (N, D^2, H, W)
    f32 on the Pallas kernel's grid (its C entry point works the origin
    out: the twin at ``grid_origin``), for D <= 21 and any stride_2
    whose haloed tiles fit the card's 227 KB of shared memory (r
    stride_2 up to 33 at D = 21)."""
    _cuda.check_cuda_tensor("a", a, torch.float32, 4)
    _cuda.check_cuda_tensor("b", b, torch.float32, 4)
    nb, h, w, c = a.shape
    if b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if c % 4:
        raise ValueError(f"correlation_cf kernel needs C % 4 == 0, got {c}")
    if nb > 65535:
        raise ValueError(f"correlation_cf kernel takes N <= 65535, got {nb}")
    geo = cf_geometry(max_displacement, stride_2)
    out = torch.empty((nb, geo.d * geo.d, h, w), dtype=torch.float32,
                      device=a.device)
    if out.numel():
        _CF_KERNEL(a.device, _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(out), nb,
                   h, w, c, max_displacement, stride_2, geo.dmax, geo.rows,
                   geo.stages)
    return out


class _CorrelationCF(torch.autograd.Function):
    """The kernel forward; the backward is the twin's autograd at origin
    0, recomputed from the saved inputs: JAX's custom_vjp backward, the
    VJP of ``correlation_xla_cf`` on the centred grid
    (correlation.py:355-362), which is the exact gradient wherever
    max_displacement % stride_2 == 0. There is no backward kernel."""

    @staticmethod
    def forward(ctx, a, b, max_displacement, stride_2):
        ctx.save_for_backward(a, b)
        ctx.args = (max_displacement, stride_2)
        return correlation_cf_cuda(a, b, max_displacement, stride_2)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            a_, b_ = a.detach().requires_grad_(), b.detach().requires_grad_()
            out = correlation_cf_plain(a_, b_, *ctx.args)
            ga, gb = torch.autograd.grad(out, (a_, b_), grad)
        return ga, gb, None, None


def correlation_cf(a: torch.Tensor, b: torch.Tensor, max_displacement: int,
                   stride_2: int = 1) -> torch.Tensor:
    """Channel-first correlation volume: (..., H, W, C) pairs ->
    (..., D^2, H, W) in the input dtype. JAX's dispatch, its TPU/other
    split mapped onto card/CPU: on the card the kernel (bf16 or f16
    maps are cast to f32 for it, it sums in f32, and the volume is cast
    back; the gradient flows through both casts) on the Pallas kernel's
    grid, on the CPU the twin on ``correlation_xla``'s centred grid. The
    two grids differ where max_displacement % stride_2 != 0."""
    if a.shape != b.shape or a.dim() < 3:
        raise ValueError(f"correlation_cf: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be equal (..., H, W, C)")
    lead = a.shape[:-3]
    a4 = a.reshape((-1,) + a.shape[-3:])
    b4 = b.reshape((-1,) + b.shape[-3:])
    if a.device.type == "cpu":
        out = correlation_cf_plain(a4, b4, max_displacement, stride_2)
    elif a.device.type == "cuda":
        out = _CorrelationCF.apply(a4.to(torch.float32).contiguous(),
                                   b4.to(torch.float32).contiguous(),
                                   max_displacement, stride_2).to(a.dtype)
    else:
        raise ValueError(f"correlation_cf: no kernel for device {a.device}")
    return out.reshape(lead + out.shape[1:])


def correlation(a: torch.Tensor, b: torch.Tensor, max_displacement: int,
                stride_2: int = 1) -> torch.Tensor:
    """Reference-layout correlation (..., H, W, D^2): the channel-first
    volume with its displacement axis moved last (a view)."""
    return correlation_cf(a, b, max_displacement, stride_2).movedim(-3, -1)
