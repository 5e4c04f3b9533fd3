"""Fixed-capacity NMS over axis-aligned BEV boxes (PyTorch port of
dodt_tpu/ops/nms.py). Three modes, picked by the config's ``nms_mode``
through ``nms_bev_mode``:

* ``nms_bev_exact`` ("exact", the default): keep[i] holds iff no KEPT
  strictly-higher-scored box overlaps i above the threshold. That
  recursion is well-founded over the strict score order, so iterating
  the parallel suppression pass until it stops changing yields exactly
  greedy NMS's keep set. On the card the whole fixpoint (the JAX
  ``while_loop``) is one kernel launch with no host sync
  (``csrc/nms_fixpoint.cu``), so the NMS can be captured in a CUDA
  graph; ``fixpoint_plain``, its plain version, is a Python loop with one
  host sync per pass (typically 2-5) and runs CPU tensors.
* ``nms_bev`` ("greedy"): the sequential oracle, ``max_out`` steps of
  argmax and suppress. The steps stay on the device (no host sync), so
  its cost is ``max_out`` rounds of small launches.
* ``nms_bev_fast`` ("fast"): one parallel pass; a box is suppressed if
  ANY strictly higher-scored box overlaps it, even a suppressed one, so
  it keeps a subset of greedy's picks.

Under a profiler each call is the span ``dodt/nms``, and each pass of
the exact mode's plain fixpoint, with its host sync, a ``dodt/nms_pass``
inside it.

The output is a static (max_out,) index vector plus a validity mask.
All functions take batched leading axes; score ties go to the lower
index, as ``jax.lax.top_k`` and ``jnp.argmax`` break them.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dodt_tpu_torch.ops import _cuda
from dodt_tpu_torch.ops.iou import aligned_iou_matrix
from dodt_tpu_torch.utils.metrics import span

NEG_INF = -1e9
_KERNEL = _cuda.CudaKernel("dodt_nms_fixpoint", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int])


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; equal values keep index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            max_out: int, iou_thresh: float):
    """Greedy NMS: ``max_out`` rounds of picking the best live box and
    suppressing it and every box over the threshold with it.

    boxes (..., N, 4) [x1, y1, x2, y2]; scores, valid (..., N).
    Returns (indices (..., max_out) int64, out_valid (..., max_out)).
    """
    with span("dodt/nms"):
        n = boxes.shape[-2]
        iou = aligned_iou_matrix(boxes, boxes)                # (..., N, N)
        live = torch.where(valid, scores, NEG_INF)
        idx = torch.arange(n, device=boxes.device)
        out_idx, out_ok = [], []
        for _ in range(max_out):
            best = live.argmax(dim=-1, keepdim=True)          # (..., 1)
            ok = live.gather(-1, best) > NEG_INF / 2
            row = torch.take_along_dim(iou, best[..., None],
                                       dim=-2)[..., 0, :]
            suppress = (row > iou_thresh) | (idx == best)
            live = torch.where(ok & suppress, NEG_INF, live)
            out_idx.append(best)
            out_ok.append(ok)
        return torch.cat(out_idx, dim=-1), torch.cat(out_ok, dim=-1)


def _dominance(boxes, scores, valid, iou_thresh):
    """(masked scores, dom): dom[..., i, j] says valid box j outscores i
    ((s_j, -j) > (s_i, -i)) and overlaps it above the threshold."""
    n = boxes.shape[-2]
    iou = aligned_iou_matrix(boxes, boxes)                    # (..., N, N)
    s = torch.where(valid, scores, NEG_INF)
    idx = torch.arange(n, device=boxes.device)
    si, sj = s[..., :, None], s[..., None, :]
    dom = (si < sj) | ((si == sj) & (idx[:, None] > idx[None, :]))
    return s, dom & (iou > iou_thresh) & valid[..., None, :]


def _top_kept(s, valid, supp, max_out):
    top_scores, out_idx = top_k(torch.where(valid & ~supp, s, NEG_INF),
                                max_out)
    return out_idx, top_scores > NEG_INF / 2


def nms_bev_fast(boxes: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, max_out: int, iou_thresh: float):
    """Fast NMS: suppress i if any higher-scored valid j overlaps it.
    Same interface as ``nms_bev``."""
    with span("dodt/nms"):
        s, dom = _dominance(boxes, scores, valid, iou_thresh)
        return _top_kept(s, valid, dom.any(dim=-1), max_out)


def fixpoint_plain(dom: torch.Tensor) -> torch.Tensor:
    """The suppression fixpoint of a dominance matrix (..., N, N) bool:
    supp[i] = any_j dom[i, j] & ~supp[j], iterated from supp = 0 until a
    pass changes nothing; (..., N) bool. One host sync a pass."""
    supp = dom.any(dim=-1)
    for _ in range(dom.shape[-1]):
        with span("dodt/nms_pass"):
            new = (dom & ~supp[..., None, :]).any(dim=-1)
            if torch.equal(new, supp):
                break
            supp = new
    return supp


def fixpoint_cuda(dom: torch.Tensor) -> torch.Tensor:
    """The kernel (``csrc/nms_fixpoint.cu``): ``fixpoint_plain``'s bits in
    one launch, with no host sync."""
    if dom.device.type != "cuda" or dom.dtype != torch.bool:
        raise ValueError(f"dom: expected a bool CUDA tensor, got "
                         f"{dom.dtype} on {dom.device}")
    if dom.dim() < 2 or dom.shape[-2] != dom.shape[-1]:
        raise ValueError(f"dom: expected (..., N, N), got "
                         f"{tuple(dom.shape)}")
    n = dom.shape[-1]
    dom = dom.contiguous()
    supp = torch.empty(dom.shape[:-1], dtype=torch.bool, device=dom.device)
    if supp.numel() == 0:
        return supp
    rows = supp.numel() // n
    words = _cuda.load().dodt_nms_fixpoint_scratch_words(n)
    scratch = (torch.empty(rows * words, dtype=torch.int32,
                           device=dom.device) if words else None)
    _KERNEL(dom.device, _cuda.ptr(dom), _cuda.ptr(supp),
            None if scratch is None else _cuda.ptr(scratch), rows, n)
    return supp


def fixpoint(dom: torch.Tensor) -> torch.Tensor:
    """The suppression fixpoint: the kernel for a CUDA tensor, the plain
    loop for a CPU one; any other device raises."""
    if dom.device.type == "cpu":
        return fixpoint_plain(dom)
    if dom.device.type != "cuda":
        raise ValueError(f"nms fixpoint: no kernel for device {dom.device}")
    return fixpoint_cuda(dom)


def nms_bev_exact(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, max_out: int, iou_thresh: float):
    """Exact greedy NMS via fixpoint iteration of the fast pass. Same
    interface as ``nms_bev``."""
    with span("dodt/nms"):
        s, dom = _dominance(boxes, scores, valid, iou_thresh)
        return _top_kept(s, valid, fixpoint(dom), max_out)


def nms_bev_mode(mode: str):
    """The NMS function of a config's ``nms_mode``."""
    if mode == "fast":
        return nms_bev_fast
    if mode == "greedy":
        return nms_bev
    if mode == "exact":
        return nms_bev_exact
    raise ValueError(
        f"nms_mode must be 'exact', 'greedy' or 'fast', got {mode!r}")


def top_k_prefilter(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k valid candidates, bounding the NMS IoU matrix."""
    top_scores, top_idx = top_k(torch.where(valid, scores, NEG_INF), k)
    return top_idx, top_scores > NEG_INF / 2
