"""Chain of 3x3 SAME conv + bias + ReLU stages (kernel B1).

Counterpart of dodt_tpu/ops/conv_chain.py, whose Pallas kernel
(``conv_chain_pallas``) runs a whole tower block — conv4: 128 -> 256 ->
256 -> 256 — as shifted matmuls on VMEM-resident row strips. Here each
stage is one launch of the CUDA kernel in ``csrc/conv_chain.cu``: an
implicit GEMM on Hopper's warpgroup tensor-core instructions (wgmma),
bf16 operands, f32 accumulation and bias, ReLU, one rounding to bf16
(the Pallas kernel's numerics). Zero padding is exact SAME at every
stage. Keeping the inter-conv activations on chip, as the Pallas kernel
does, is later work.

The kernel reads its weights K-major, (Co, 9 * Ci) bf16
(``pack_weights``). The pack and the f32 bias are made once per
parameter and cached on the parameter tensor, keyed by its storage and
its ``_version``, so a call launches only the convs, and an optimiser
step or ``load_state_dict`` (which bump ``_version``) re-packs.

``conv_chain`` dispatches on the input's device: CPU tensors take the
plain PyTorch twin ``conv_chain_plain``, CUDA tensors the kernel (bf16
only) inside an autograd Function whose backward is the twin's
autograd, anything else raises. The model runs the kernel on eval
paths only, as the JAX model does (dt_avod.py:389-394): training takes
plain convolutions.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from dodt_tpu_torch.ops import _cuda

_KERNEL = _cuda.CudaKernel("dodt_conv3x3_bias_relu", [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)


def conv_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain twin: per stage, the f32 conv of the stage's input values
    (OIHW weights cast to the input dtype first) + f32 bias, ReLU, and
    one rounding back to the input dtype. x: (B, H, W, Ci) NHWC."""
    h = x.permute(0, 3, 1, 2)
    for w, b in zip(weights, biases):
        y = F.conv2d(h.float(), w.to(x.dtype).float(), b.float(), padding=1)
        h = torch.relu(y).to(x.dtype)
    return h.permute(0, 2, 3, 1)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, 3, 3) -> the kernel's K-major (Co, 9 * Ci) bf16:
    packed[o, (ky * 3 + kx) * Ci + i] = w[o, i, ky, kx]."""
    co, ci = w.shape[0], w.shape[1]
    return w.detach().permute(0, 2, 3, 1).reshape(co, 9 * ci).to(
        torch.bfloat16).contiguous()


def _packed(w: torch.Tensor, b: torch.Tensor):
    """(packed weights, f32 bias) of one stage, cached on ``w``."""
    key = (w.data_ptr(), w._version, b.data_ptr(), b._version, w.device)
    hit = getattr(w, "_dodt_conv_pack", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weights(w),
               b.detach().to(torch.float32).contiguous())
        w._dodt_conv_pack = hit
    return hit[1], hit[2]


def conv3x3_bias_relu_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """One stage on the card: x (B, H, W, Ci) bf16, w_packed (Co, 9 * Ci)
    bf16 (``pack_weights``), bias (Co,) f32 -> (B, H, W, Co) bf16."""
    _cuda.check_cuda_tensor("x", x, torch.bfloat16, 4)
    _cuda.check_cuda_tensor("w", w_packed, torch.bfloat16, 2)
    _cuda.check_cuda_tensor("bias", bias, torch.float32, 1, align=8)
    nb, h, wd, ci = x.shape
    co = w_packed.shape[0]
    if ci % 8 or co % 8:
        raise ValueError(f"conv3x3 kernel needs Ci and Co multiples of 8, "
                         f"got Ci={ci}, Co={co}")
    if w_packed.shape[1] != 9 * ci or bias.shape[0] != co:
        raise ValueError(f"weights {tuple(w_packed.shape)} / bias "
                         f"{tuple(bias.shape)} do not match Ci={ci}")
    if not (x.device == w_packed.device == bias.device):
        raise ValueError("x, w and bias must be on one device")
    y = torch.empty((nb, h, wd, co), dtype=torch.bfloat16, device=x.device)
    if y.numel():
        _KERNEL(x.device, _cuda.ptr(x), _cuda.ptr(w_packed),
                _cuda.ptr(bias), _cuda.ptr(y), nb, h, wd, ci, co)
    return y


def conv_chain_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The chain on the card, one kernel launch per stage."""
    h = x.contiguous()
    for w, b in zip(weights, biases):
        h = conv3x3_bias_relu_cuda(h, *_packed(w, b))
    return h


class _ConvChain(torch.autograd.Function):
    """The kernel forward; the backward is the twin's autograd,
    recomputed from the saved input and parameters (the JAX custom_vjp
    ``_conv_chain_tpu`` replays ``conv_chain_xla``, conv_chain.py:216-238;
    there is no backward kernel). apply(x, *weights, *biases)."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        n = len(params) // 2
        return conv_chain_cuda(x, params[:n], params[n:])

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, params = saved[0], saved[1:]
            n = len(params) // 2
            out = conv_chain_plain(x, params[:n], params[n:])
            grads = torch.autograd.grad(out, saved, grad)
        return grads


def conv_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """[3x3 SAME conv -> +bias -> ReLU] per stage over NHWC x
    (B, H, W, Ci); weights OIHW (Co, Ci, 3, 3), biases (Co,).
    Differentiable w.r.t. x and every weight and bias on both routes."""
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"conv_chain: no kernel for device {x.device}")
    return _ConvChain.apply(x, *weights, *biases)
