#!/usr/bin/env python
"""Smoke run of the PyTorch port (dodt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, prints "chip_smoke FAILED:"
and its reason on stdout and stderr, and prints no result:
  1. build the CUDA kernel library from dodt_tpu_torch/csrc (nvcc, sm_90a,
     one compiler process per source, all started together); no kernel
     may spill registers (the compiler's -Xptxas -v report);
  2. hold each kernel against its plain PyTorch twin on the card at the
     shapes the model paths give it (B1 at the keyframe's batch 1, the
     pair's 2 and the Stack's 4 frames; B2 on 2 and on the Stack's 4
     maps, f32 and bf16; B3 and its blur form, corr_bottleneck_blur, at
     the main path's and other D, strides, Cb and odd maps, on the
     blur's displacement grid (the model's) and, where max_displacement
     % stride_2 != 0, the twin on the centred grid too; B4 on the Pallas
     kernel's grid at the public op's and at other D, strides ((5, 2)
     and (3, 2) at the full-width shape), channels, odd maps, N = 3 and
     bf16 inputs (a bf16 volume)), and time both after warm-up (timed():
     per-call time through the wrapper, device time with the host out
     of the way, host time per enqueue); B4's gradient route against
     the twin's autograd; the exact NMS's fixpoint kernel bit for bit
     against its plain loop at N = 300, 1200 and 4096 (the second
     stage's, the RPN's at eval and in training), timed;
  3. run the full-width cars_dt_tracking slice (seeded random weights,
     make_batch inputs, 65536 points) through StreamingPredictor on
     the static arm and the ego-motion arm; outputs must be finite and
     shaped, and every kernel's launch counter, zeroed just before, must
     have grown; one more keyframe, its aten ops counted, must launch B2
     once and cast no whole f32 feature map to bf16;
  4. run a small config on the card and on the CPU with the same weights
     and compare the frame state and the final detections;
  5. run the full-width monolithic pair forward (DtAvodNet.forward, B = 1,
     F = 2, the bench inputs) and time it; outputs must be finite and
     shaped, and B1, B2 and B3's counters, zeroed just before, must grow;
     the second stage's time eager against replayed from its CUDA graph
     (the pair stage of two encoded frames); then drive B4's public op
     (correlation, through correlation_cf) on the full-width BEV feature
     shape with the counters zeroed again;
  6. run the monolithic forward of the small config at B = 2 on the card
     and on the CPU with the same weights and compare them;
  7. train the full-width cars_dt_tracking model (B = 1 couple, train=True:
     dropout, path drop, sampling) for a few steps through Trainer.train on
     an in-memory stream (make_batch's couple with seeded GT cars);
     one step's gradients, taken twice from one state with the same
     draws, must be bit-equal in every leaf (the count of leaves that
     differ is printed), finite for every parameter and non-zero
     for B3's weights, every loss term finite and non-zero, B3's counter
     must grow and B1's and B2's (eval-only) stay 0; prints the median
     step time and the peak memory (of the route the step takes, B3's
     backward through the blur VJP), and phase 2's B3 backward times on
     both routes against its forward;
  8. one train step of the small config on the card and on the CPU with
     the same weights and draws (dropout off): losses and every gradient
     compared;
  9. evaluate phase 7's checkpoint at full width through
     Evaluator.run_checkpoint_once (cars_dt_tracking(data_stride=3),
     val_health on) on a synthetic fixture of two videos (static and ego
     motion, 10 frames, 4 cars; no PNGs, the images are the fixture's
     flat gray cards), twice: B1-B3 launched per forward, B4 not, the
     native AP route equal to the Python route, every result key and
     finite number, a prediction file for every frame and couple; prints
     eval couples/s and the time of each stage;
 10. run_checkpoint_once of the small config (f32 towers, plain convs)
     on one ego-motion video at data_stride 3 on the card and on the CPU,
     from one checkpoint: the per-frame boxes and the AP and MOT results
     compared;
 11. the staged training flow at full width through Trainer: the
     single-frame detector (cars_single_frame, DtAvodNet(num_frames=1))
     trains 3 steps on a one-frame stream, its forward is timed and its
     checkpoint evaluated detection-only (KITTI object fixture without
     PNGs, 8 samples, twice) with B1 and B2 launched in every forward;
     cars_dt_tracking_staged restores and freezes its seven detector
     subtrees for 2 steps of the paired model (every frozen tensor
     bit-equal, the correlation branch moved), and
     cars_dt_tracking_finetune continues one step (the detector moves);
     prints the single-frame forward ms, detection-eval samples/s and its
     stages;
 12. the Stack model at full width (cars_dt_tracking(data_stride=3),
     stack_avod_model, 4 frames, random weights): its forward timed with
     B1 and B2 launched, 2 Trainer steps (compute_stack_losses; step ms,
     peak memory), and run_checkpoint_once over phase 9's fixture read
     through KittiTrackingStackDataset (val_health on), every result
     finite and every file present;
 13. the one-frame and the Stack forward of the small config (f32, plain
     convolutions) on the card against the CPU (phase 6's rule), and the
     one-frame model's detection-only evaluation on the card against the
     CPU (phase 10's rule);
 14. the model variants at full width (random weights, 65536 points):
     V1 box_8c, late fusion by max, plain VGG towers, fast NMS; V2
     box_3d, deep fusion by mean, GroupNorm towers, greedy NMS; V3 the
     people preset's two-class head, box_8co, early fusion by concat.
     Each: the val pair forward timed with its B1-B3 launches (B1 on V1
     and V3, not on V2; B2 and B3 on all), one Trainer step (finite
     losses, step ms, peak memory); V2 also timed with exact NMS;
 15. V1-V3 at the small config's widths (f32, plain convolutions) on the
     card against the CPU (phase 6's rule);
 16. the CLI (dodt_tpu_torch.cli.main) at full width on a JSON config
     over phase 9's fixture: train (2 steps), evaluate (every result and
     file, B1-B3 per couple), infer (fps_pairs) and, where matplotlib is
     installed, demo; then the offline video MOT over evaluate's files:
     the IoU and Kalman arms over the couple files (the IoU arm's tracks
     equal to those from the evaluator's in-memory detections) and the
     IoU arm over the per-frame files, scored;
 17. the mesh (dodt_tpu_torch.parallel) at full width (cars_dt_tracking,
     65536 points, phase 7's weights and stream, phase 9's fixture).
     (a) a (1, 1) mesh over one NCCL rank in this process: 3 Trainer
     steps against the meshless Trainer's (every step's losses
     bit-equal), 3 make_train_step steps each from one state (losses,
     Adam's moments, params and EMA bit-equal to the meshless step's),
     run_checkpoint_once of
     the mesh's checkpoint (results JSON equal to the meshless run's),
     B3 launched in training and B1-B3 6, 1, 1 times per evaluated
     forward. At size 1 the mesh runs no collective: (a) holds the
     mesh's code paths, not NCCL's transport. (b) two ranks on the one
     card over gloo (NCCL refuses two ranks on one GPU; gloo stages CUDA
     tensors through the host), each against this process's run of the
     same program: a (2, 1) step at B = 2 (its losses and state against
     the two couples' computed one by one in one process, split_step,
     the RPN's losses against the B = 2 step's too,
     and how many proposals the B = 2 forward swaps against each
     couple's own logged), the (1, 2)
     TP forward (check_tp_forward: each output within one bf16 ulp,
     every box matched) and step at B = 1 (the steps in f32; both ranks'
     states bit-equal, each within close_states' bounds), and the
     Evaluator with data = 2 (results and files equal); prints each
     rank's step ms, bytes moved and peak memory;
 18. the last ported ops on the card against the CPU (rotated and 3D IoU,
     the 3D integral image and its query, point projection, the area
     mask, bev_pixel_from_xz) and the metrics helpers (device_sync,
     profile_trace) on the card;
 20. the full-width BEV rasterization on the card against the CPU, bit
     for bit, on bench's points (both frames, on bench's ground plane
     and on a tilted one) and on points on every cell and slice edge,
     and how many edge coordinates dividing by the voxel size puts in
     another cell on the card than on the CPU. The val forward and the
     train step rasterize through the one form (ROADMAP C24);
 21. the flagship's full-width monolithic forward (bf16 towers, seeded
     weights, bench's couple) on the card against the CPU: bev_input
     bit-equal, the top proposals matched as sets, the valid final
     counts within a fifth (tests/test_torch_full_width_forward.py's
     bf16 rule);
 22. the full-width train step (f32 towers, phase 7's weights and
     couple, one set of draws) through make_train_step on the card and
     on the CPU, SGD at lr 1 without clipping: bev_input bit-equal, the
     masks and the RPN mini-batch's selection exact, the losses and
     every gradient within the bounds measured on the card
     (STEP22_*); B3 launched once and its backward run in the card's
     step; prints the step's ms and peak memory
     (tests/test_torch_full_width_train.py holds the CPU step to JAX's).

Phase 2 also holds B3's and B1's autograd routes against the twins'
autograd: B3's kernel forward with its backward through the blur form
(corr_bottleneck_vjp), B1's kernel forward with the twin's autograd
backward; it times B3's backward on both routes, the blur VJP (the
route taken, ``bwd_ms``) and the twin's autograd (``bwd_ms_twin``),
and holds the route's gradients to the twin's a second time with
cudnn.allow_tf32 at PyTorch's default, True, which the port's entry
points run under (``bwd_rel_err_tf32``, the largest error over max
|ref|); the JSON ``kernels`` line carries these. For each kernel it
prints its time through the wrapper (``ms``), its device time
(``device_ms``) and host time per call (``host_us``), the least time
the card could take for the same work (bytes over HBM's rate or
operations over the peak rate of their type, whichever is larger) and
that bound's share of ``device_ms``, the same three times of the one
PyTorch call that computes the same function (B1: cuDNN bf16 convs;
B2: F.grid_sample; B3: the blur form, a cuDNN depthwise conv and a
reduce, as JAX's XLA path computes it; B4: none, no PyTorch call
computes the raw volume) and the twin's time. ``ms`` is
what a host-bound caller pays; ``device_ms`` is the kernel's own work,
so a kernel is compared with its library call by ``device_ms``.

    python3 chip_smoke.py --mesh-cards

runs phase 1 and then phase 19 on a host of 4 or more cards (an even
number), one NCCL rank per card: a (n/2, 2) momentum step, TP forward
and MESH_STEPS Adam steps and a (n, 1) evaluation against one card
(mesh_cards), so every collective of the mesh runs over NCCL; then the
documented command, ``torchrun --nproc_per_node n -m dodt_tpu_torch.cli
train --num_model 2``, for 2 steps at full width against the one-card
command (torchrun_train); its last line names the count of cards.

    python3 chip_smoke.py --compare-kernels DIR

times the kernels of the tree unpacked at DIR (for example the parent
commit, ``git archive HEAD | tar -x -C build/parent``) and of this tree
with this file's timing code (kernel_times: the public functions both
trees keep), each tree in its own process with its own kernel build, in
turns DIR, this, this, DIR, and prints each kernel's and library call's
ms, device_ms and host_us per turn, then one JSON line of them all.

TF32 is off for the whole run (cuDNN and cuBLAS), so every f32 op on the
card is a full f32 op and the comparisons measure the kernels alone.

The second-to-last line of stdout holds the card's name and power limit,
the line before it one JSON object with each kernel's launches (on the
path that runs it: B1-B3 the streaming slice, with the monolithic
forward's, the train step's and the evaluation's counts beside it,
``evaluate`` per evaluated couple, and the single-frame forward's, per
single-frame evaluated sample, the Stack forward's and per evaluated
stack, each variant's forward, per CLI-evaluated couple, per mesh train
step and per mesh-evaluated couple (phase 17), each rank's, and phase
22's f32 train step; B4 its public ops), error and times;
the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_WARM, N_TIMED = 3, 20
# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def fail(msg):
    """Report a failure on stdout and stderr alike; returns the exit
    code."""
    print(f"chip_smoke FAILED: {msg}", flush=True)
    log(f"chip_smoke FAILED: {msg}")
    return 1


def cuda_time_ms(fn, n_warm=N_WARM, n_timed=N_TIMED):
    """Mean time per call of n_timed back-to-back calls of fn(), CUDA
    events: host and device as a caller meets them."""
    import torch
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_timed):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_timed


SLEEP_CYCLES = 10_000_000      # torch.cuda._sleep: about 5-7 ms on an H100


def timed(*fns, n_warm=N_WARM, n_timed=N_TIMED):
    """Times of the calls fns(), each timed alone and summed:
      ms         cuda_time_ms: the time a caller meets, host included
                 wherever the host enqueues slower than the card runs;
      device_ms  the same n_timed calls queued behind torch.cuda._sleep,
                 which holds the card until the host has enqueued all of
                 them (checked with the host clock, the sleep doubled
                 until it holds), so the events bracket device work alone;
      host_us    the host clock around those n_timed enqueues, per call.
    """
    import torch
    out = {"ms": 0.0, "device_ms": 0.0, "host_us": 0.0}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for fn in fns:
        out["ms"] += cuda_time_ms(fn, n_warm, n_timed)
        cycles = SLEEP_CYCLES
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            torch.cuda._sleep(cycles)
            ev[1].record()
            t1 = time.perf_counter()
            for _ in range(n_timed):
                fn()
            t2 = time.perf_counter()
            ev[2].record()
            torch.cuda.synchronize()
            if (t2 - t0) * 1e3 < ev[0].elapsed_time(ev[1]):
                break
            cycles *= 2
        else:
            raise PhaseError("the host's enqueue outlasted the card's sleep")
        out["device_ms"] += ev[1].elapsed_time(ev[2]) / n_timed
        out["host_us"] += (t2 - t1) / n_timed * 1e6
    return out


def rel_err(got, want):
    """(max |got - want|, max |want|) in float32."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()), float(w.abs().max())


def bound(flops, peak, nbytes):
    """(least ms the card could take, "operations" or "bytes"): the
    larger of flops over the peak rate of their type and nbytes (each
    input read once, each output written once) over HBM's rate."""
    t_op, t_mem = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def spills(compiler_output):
    """The kernels whose -Xptxas -v report has spill stores or loads."""
    found, entry = [], None
    for line in compiler_output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            found.append(entry)
    return found


# ---------------------------------------------------------------- phase 2

def main_inputs(dev):
    """B1-B4's inputs at the shapes the main paths give them, from seed
    0: B1 both towers' conv4 (bf16 maps, 128 -> 256 -> 256 -> 256), B2
    two f32 BEV maps with 300 car-sized boxes each in normalised BEV
    coords (80 m x 70 m map; ten oversized ones exercise the window-edge
    clamp), B3 and B4 two full-width BEV feature maps and B3's (121, 1)
    bottleneck weights."""
    import torch
    g = torch.Generator().manual_seed(0)
    chans = (128, 256, 256, 256)
    ws = [(torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5).to(dev)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [(0.1 * torch.randn(co, generator=g)).to(dev) for co in chans[1:]]
    xs = [torch.relu(torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
          for shape in ((1, 88, 100, 128), (1, 45, 150, 128))]
    maps, boxes = bev_crop_inputs(g, 2, dev)
    a, b = (torch.randn((1, 350, 400, 32), generator=g).to(dev)
            for _ in range(2))
    w = (torch.randn((121, 1), generator=g) / 11.0).to(dev)
    return {"chans": chans, "ws": ws, "bs": bs, "xs": xs, "maps": maps,
            "boxes": boxes, "a": a, "b": b, "w": w}


def bev_crop_inputs(g, m, dev):
    """B2's inputs for m frames: f32 (m, 350, 400, 32) BEV maps and 300
    car-sized boxes each in normalised BEV coords (80 m x 70 m map; ten
    oversized ones exercise the window-edge clamp)."""
    import torch
    maps = torch.randn((m, 350, 400, 32), generator=g).to(dev)
    cy = torch.rand((m, 300), generator=g) * 0.9 + 0.05
    cx = torch.rand((m, 300), generator=g) * 0.9 + 0.05
    hy = (torch.rand((m, 300), generator=g) * 2.5 + 1.0) / 70.0
    hx = (torch.rand((m, 300), generator=g) * 2.5 + 1.0) / 80.0
    hy[:, :10] *= 6.0
    hx[:, :10] *= 6.0
    boxes = torch.stack([cy - hy, cx - hx, cy + hy, cx + hx], -1).to(dev)
    return maps, boxes


def library_calls(inp):
    """The one PyTorch call that computes a kernel's function, where there
    is one: B1's chain as cuDNN bf16 convs (a function of the map), B2
    F.grid_sample on the crops' sample lattice (the gather crop's,
    align_corners: pixel centres at -1 .. 1; it reads the f32 map and
    agrees with B2 on the ROIs that fit their window). B3's is the blur
    form (kernel_times: the port's corr_bottleneck_blur, a cuDNN
    depthwise conv and a reduce; the form JAX's XLA path computes, and
    the port's B3 backward); B4 has none: no PyTorch call computes the
    raw volume. The port calls neither of these two."""
    import torch
    import torch.nn.functional as F
    from dodt_tpu_torch.ops import roi
    bf_ws = [w.to(torch.bfloat16) for w in inp["ws"]]
    bf_bs = [b.to(torch.bfloat16) for b in inp["bs"]]

    def cudnn_chain(x):
        h = x.permute(0, 3, 1, 2)
        for w, b in zip(bf_ws, bf_bs):
            h = torch.relu(F.conv2d(h, w, b, padding=1))
        return h

    maps, boxes = inp["maps"], inp["boxes"]
    m, hh, ww, _ = maps.shape
    n = boxes.shape[1]
    bx = boxes.reshape(-1, 4)
    ys = roi.sample_grid(bx, hh, bx[:, 0], bx[:, 2], 7)
    xs = roi.sample_grid(bx, ww, bx[:, 1], bx[:, 3], 7)
    grid = torch.stack([(2 * xs / (ww - 1) - 1)[:, None, :].expand(-1, 7, 7),
                        (2 * ys / (hh - 1) - 1)[:, :, None].expand(-1, 7, 7)],
                       -1).reshape(m, n * 7, 7, 2)
    maps_nchw = maps.permute(0, 3, 1, 2)

    def grid_sample():
        return F.grid_sample(maps_nchw, grid, align_corners=True)
    return cudnn_chain, grid_sample


def kernel_times(dev, inp=None):
    """timed() of each kernel through its public function at the
    main-path shapes, and of its library call: {name: {"ms", "device_ms",
    "host_us", "library_ms", "library_device_ms", "library_host_us"}}.
    It calls only what every tree of the port has, with the signatures
    they all keep (B3's library route, corr_bottleneck_blur, where the
    tree has it), so that --compare-kernels times another tree's kernels
    with this tree's code."""
    from dodt_tpu_torch.ops import conv_chain as cc
    from dodt_tpu_torch.ops import correlation as corr
    from dodt_tpu_torch.ops import roi_window
    inp = inp or main_inputs(dev)
    cudnn_chain, grid_sample = library_calls(inp)
    ws, bs, xs = inp["ws"], inp["bs"], inp["xs"]
    maps, boxes, a, b, w = (inp[k] for k in ("maps", "boxes", "a", "b", "w"))
    pairs = {
        "conv_chain": (
            timed(*(lambda x=x: cc.conv_chain(x, ws, bs) for x in xs)),
            timed(*(lambda x=x: cudnn_chain(x) for x in xs))),
        "roi_window": (
            timed(lambda: roi_window.crop_and_resize_window(maps, boxes, 7)),
            timed(grid_sample)),
        "corr_bottleneck": (
            timed(lambda: corr.corr_bottleneck(a, b, w, 5)),
            timed(lambda: corr.corr_bottleneck_blur(a, b, w, 5))
            if hasattr(corr, "corr_bottleneck_blur") else None),
        "correlation_cf": (timed(lambda: corr.correlation_cf(a, b, 5)),
                           None)}
    return {name: {**k, **{"library_" + key: (lib or {}).get(key)
                           for key in ("ms", "device_ms", "host_us")}}
            for name, (k, lib) in pairs.items()}


def kernel_checks(dev):
    """Each kernel against its plain twin at the main-path shapes (and
    the small config's and odd ones), timed (kernel_times) beside the
    twin, with the least time the card could take. Returns {name:
    {"max_abs_err", "plain_ms", "bound_ms", "bound_by", and
    kernel_times' keys}}."""
    import torch
    from dodt_tpu_torch.ops import conv_chain as cc
    from dodt_tpu_torch.ops import correlation as corr
    from dodt_tpu_torch.ops import roi, roi_window

    inp = main_inputs(dev)
    g = torch.Generator().manual_seed(1)
    res = {}

    def chain_params(chans):
        ws = [(torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5
               ).to(dev) for ci, co in zip(chans[:-1], chans[1:])]
        bs = [(0.1 * torch.randn(co, generator=g)).to(dev)
              for co in chans[1:]]
        return ws, bs

    def check_chain(x, ws, bs, what):
        got = cc.conv_chain(x, ws, bs)
        want = cc.conv_chain_plain(x, ws, bs)
        check(got.shape == want.shape and got.dtype == torch.bfloat16,
              f"conv_chain shape/dtype {got.shape} {got.dtype}")
        e, scale = rel_err(got, want)
        # bf16 output: the twin rounds each stage once like the kernel;
        # the f32 sum order differs, so a rounding may flip by one ulp
        # and propagate: allow 2e-2 of the output's range (~5 ulps)
        log(f"B1 conv_chain {what} {tuple(x.shape)}: max_abs_err {e:.4g} "
            f"(max |ref| {scale:.4g})")
        check(e <= 2e-2 * scale, f"conv_chain {what} disagrees: {e} vs "
              f"{scale}")
        return e

    # B1: conv4 block of both towers, 128 -> 256 -> 256 -> 256, bf16
    chans, ws, bs, xs = (inp[k] for k in ("chans", "ws", "bs", "xs"))
    err = max(check_chain(x, ws, bs, "conv4") for x in xs)
    # the monolithic forward hands B1 both frames of a couple at once, and
    # the Stack model its 4 frames (data_stride 3) in each per-frame tower
    for shape in ((2, 88, 100, 128), (4, 88, 100, 128), (4, 45, 150, 128)):
        x_f = torch.relu(torch.randn(shape, generator=g)).to(
            dev, torch.bfloat16)
        check_chain(x_f, ws, bs, "conv4")
    del x_f
    # the small config's conv4 (16 -> 16, phases 4 and 6 at batch 4), and
    # an odd-sized map through Ci and Co that are multiples of 8 only
    for shape, ch in (((4, 30, 20, 16), (16, 16)),
                      ((2, 13, 21, 40), (40, 72, 24))):
        sw, sb = chain_params(ch)
        check_chain(torch.relu(torch.randn(shape, generator=g)).to(
            dev, torch.bfloat16), sw, sb, "small/odd")
    px = sum(x.shape[0] * x.shape[1] * x.shape[2] for x in xs)
    flops = 2 * 9 * px * sum(ci * co for ci, co in zip(chans[:-1],
                                                       chans[1:]))
    packs = [cc._packed(w, b) for w, b in zip(ws, bs)]
    io = sum(nbytes(x) + x[..., :1].numel() * chans[-1] * 2 for x in xs)
    res["conv_chain"] = {
        "max_abs_err": err,
        "plain_ms": sum(cuda_time_ms(lambda x=x: cc.conv_chain_plain(
            x, ws, bs)) for x in xs)}
    res["conv_chain"]["bound_ms"], res["conv_chain"]["bound_by"] = bound(
        flops, PEAK_BF16, io + sum(nbytes(*pk) for pk in packs))

    def check_window(maps, boxes):
        """B2 on maps read in their own dtype (f32), and on the same maps
        in bf16, against its twin. Returns the f32 crop and its error."""
        got = roi_window.crop_and_resize_window(maps, boxes, 7)
        maps_bf = maps.to(torch.bfloat16)
        got_bf = roi_window.crop_and_resize_window(maps_bf, boxes, 7)
        shape = tuple(got.shape)
        for what, crop, m_in in (("f32", got, maps),
                                 ("bf16", got_bf, maps_bf)):
            want = roi_window.crop_and_resize_window_plain(m_in, boxes, 7)
            e, scale = rel_err(crop, want)
            # the kernel rounds each tap to bf16 (the twin casts the map)
            # and blends in the twin's f32 arithmetic without fused
            # multiply-adds: equal, and within one bf16 rounding at worst
            log(f"B2 roi_window {shape} on {what} maps: max_abs_err vs "
                f"twin {e:.4g} (max |ref| {scale:.4g})")
            check(e <= 1e-2 * scale, f"roi_window {shape} on {what} maps "
                  f"disagrees with its twin: {e}")
            if what == "f32":
                err = e
        # a tap rounded to bf16 is the bf16 map's tap: the crops are equal
        e_fb = rel_err(got, got_bf)[0]
        log(f"B2 {shape} crop of the f32 maps vs crop of their bf16 cast: "
            f"max_abs_err {e_fb:.4g}")
        check(e_fb == 0, f"roi_window f32 and bf16 maps differ by {e_fb}")
        return got, err

    # B2: 2 frames x 300 proposals x 7x7 from (350, 400, 32) f32 maps, and
    # the Stack model's 4 frames (data_stride 3) at the same sizes
    maps4, boxes4 = bev_crop_inputs(g, 4, dev)
    check_window(maps4, boxes4)
    del maps4, boxes4
    maps, boxes = inp["maps"], inp["boxes"]
    got, err = check_window(maps, boxes)
    # ROIs that fit their window: the window crop equals the gather crop
    # up to the bf16 rounding of the taps
    gather = torch.stack([roi.crop_and_resize_gather(m, b, 7)
                          for m, b in zip(maps, boxes)])
    fits = roi_window.window_fits(maps.shape, boxes, 7)
    e_g, scale_g = rel_err(got[fits], gather[fits])
    log(f"B2 roi_window vs gather on {int(fits.sum())} of {fits.numel()} "
        f"ROIs that fit: max_abs_err {e_g:.4g} (max |ref| {scale_g:.4g})")
    check(e_g <= 2e-2 * scale_g, f"roi_window disagrees with gather: {e_g}")
    # the library call reproduces the crop on the ROIs that fit only
    lib = library_calls(inp)[1]().reshape(2, 32, 300, 7, 7).permute(
        0, 2, 3, 4, 1)
    for what, sel in (("fitting", fits), ("all", slice(None))):
        e_l, scale_l = rel_err(lib[sel], got[sel])
        log(f"B2 library call F.grid_sample vs the kernel on {what} ROIs: "
            f"max_abs_err {e_l:.4g} (max |ref| {scale_l:.4g}); within the "
            f"bf16 tolerance (2e-2 of the range): {e_l <= 2e-2 * scale_l}")
    # bytes: the distinct map pixels the crops tap (this run's boxes), the
    # boxes and the bf16 crops; 3 adds + 6 mults per output value
    oy, ox, ys_rel, xs_rel = roi_window._window_coords(maps.shape, boxes, 7,
                                                       64)
    iy = torch.clamp(ys_rel, 0, 63).floor().long()
    ix = torch.clamp(xs_rel, 0, 63).floor().long()
    tapped = torch.zeros((2, 350, 400), dtype=torch.bool, device=dev)
    mi = torch.arange(2, device=dev).repeat_interleave(300)[:, None, None]
    for dy in (0, 1):
        for dx in (0, 1):
            tapped[mi, (oy[:, None] + (iy + dy).clamp(max=63))[:, :, None],
                   (ox[:, None] + (ix + dx).clamp(max=63))[:, None, :]] = True
    res["roi_window"] = {
        "max_abs_err": err,
        "plain_ms": cuda_time_ms(
            lambda: roi_window.crop_and_resize_window_plain(maps, boxes, 7))}
    res["roi_window"]["bound_ms"], res["roi_window"]["bound_by"] = bound(
        9 * got.numel(), PEAK_F32,
        int(tapped.sum()) * 32 * 4 + nbytes(boxes, got))
    del gather, lib

    # B3: correlation (d = 5, 121 displacements) + (121, 1) bottleneck
    a, b, w = inp["a"], inp["b"], inp["w"]
    err = 0.0
    # the main path, the small config's d = 2 (D = 5) at batch 2, and
    # Cb = 2..4 with stride_2 = 2 and odd sizes against the twin; at
    # (5, 2) and (3, 2) the blur's grid (the model's and the kernel's,
    # grid_origin 1) parts from the centred one
    for aa, bb, ww, md, s2 in (
            (a, b, w, 5, 1),
            *((torch.randn(shape, generator=g).to(dev),
               torch.randn(shape, generator=g).to(dev),
               (torch.randn((d * d, cb), generator=g) / d).to(dev), md, s2)
              for shape, md, s2, d, cb in (
                  ((2, 240, 160, 16), 2, 1, 5, 1),
                  ((2, 61, 77, 8), 5, 2, 5, 2),
                  ((2, 61, 77, 8), 3, 2, 3, 1),
                  ((2, 64, 96, 32), 5, 1, 11, 4),
                  ((1, 33, 47, 24), 5, 1, 11, 3)))):
        origin = corr.grid_origin(md, s2)
        got = corr.corr_bottleneck(aa, bb, ww, md, s2)
        want = corr.corr_bottleneck_plain(aa, bb, ww, md, s2, origin)
        blur = corr.corr_bottleneck_blur(aa, bb, ww, md, s2)
        check(got.shape == want.shape == blur.shape,
              f"corr_bottleneck shape {got.shape}, blur {blur.shape}")
        e, scale = rel_err(got, want)
        e_b = rel_err(blur, want)[0]
        # f32 sums of D^2 x C products in another order: 1e-4 of the
        # range, for the kernel and for the blur form (its library route
        # and backward)
        log(f"B3 corr_bottleneck {tuple(aa.shape)} d {md} stride_2 {s2} "
            f"Cb {ww.shape[1]} on the blur's grid (origin {origin}): "
            f"max_abs_err {e:.4g}, blur form {e_b:.4g} (max |ref| "
            f"{scale:.4g})")
        check(e <= 1e-4 * scale, f"corr_bottleneck disagrees: {e}")
        check(e_b <= 1e-4 * scale, f"corr_bottleneck_blur disagrees: {e_b}")
        if origin:
            apart = rel_err(
                want, corr.corr_bottleneck_plain(aa, bb, ww, md, s2))[0]
            log(f"B3 d {md} stride_2 {s2}: the twins on the blur's and "
                f"the centred grid part by {apart:.4g}")
            check(apart > 0.1 * scale, "the grids do not part at "
                  f"d {md} stride_2 {s2}")
        if aa is a:
            err = e
    px = 350 * 400
    res["corr_bottleneck"] = {
        "max_abs_err": err,
        "plain_ms": cuda_time_ms(
            lambda: corr.corr_bottleneck_plain(a, b, w, 5))}
    res["corr_bottleneck"]["bound_ms"], res["corr_bottleneck"]["bound_by"] = \
        bound(2 * px * 121 * (32 + 1), PEAK_F32,
              nbytes(a, b, w) + px * 4)

    # B4: the raw volume, (1, 350, 400, 32) f32, d = 5 -> (1, 121, 350, 400)
    # (67.8 MB); D = 5 and D = 11 at stride_2 = 2, D = 3 at stride_2 = 2,
    # D = 21, C = 8, 16 and 64, odd maps, N = 3, and bf16 inputs (the f32
    # kernel's volume cast to bf16, the f32 volume held against the twin
    # on the inputs' f32 values), each against the twin on the Pallas
    # kernel's grid (origin 1 at (5, 2) and (3, 2)). f32 sums of C
    # products in another order: 1e-5 of the range.
    err = 0.0
    for shape, md, s2, dtype in (
            ((1, 350, 400, 32), 5, 1, torch.float32),
            ((2, 64, 96, 32), 5, 2, torch.float32),
            ((1, 350, 400, 32), 5, 2, torch.float32),
            ((1, 350, 400, 32), 3, 2, torch.float32),
            ((2, 61, 77, 32), 10, 2, torch.float32),
            ((1, 45, 67, 16), 10, 1, torch.float32),
            ((3, 40, 72, 8), 5, 1, torch.float32),
            ((1, 33, 50, 64), 5, 1, torch.float32),
            ((2, 47, 81, 32), 5, 1, torch.bfloat16)):
        aa, bb = (a, b) if shape == tuple(a.shape) else (
            torch.randn(shape, generator=g).to(dev, dtype) for _ in range(2))
        got = corr.correlation_cf(aa, bb, md, s2)
        vol = got if dtype == torch.float32 else corr.correlation_cf_cuda(
            aa.float().contiguous(), bb.float().contiguous(), md, s2)
        check(got.dtype == dtype and torch.equal(got, vol.to(dtype)),
              f"correlation_cf {got.dtype} is not the kernel's volume in "
              f"the input dtype {dtype}")
        origin = corr.grid_origin(md, s2)
        want = corr.correlation_cf_plain(aa.float(), bb.float(), md, s2,
                                         origin)
        check(got.shape == want.shape, f"correlation_cf shape {got.shape}")
        e, scale = rel_err(vol, want)
        del got, vol, want
        log(f"B4 correlation_cf {tuple(aa.shape)} {str(dtype)[6:]} d {md} "
            f"stride_2 {s2} (grid origin {origin}): max_abs_err {e:.4g} "
            f"(max |ref| {scale:.4g})")
        check(e <= 1e-5 * scale, f"correlation_cf disagrees: {e}")
        if aa is a and s2 == 1:
            err = e
    # the CUDA route's gradients are the twin's autograd
    ga, gb = (torch.randn((1, 20, 24, 8), generator=g).to(dev)
              .requires_grad_() for _ in range(2))
    pa, pb = (t.detach().clone().requires_grad_() for t in (ga, gb))
    gw = torch.randn((1, 121, 20, 24), generator=g).to(dev)
    (corr.correlation_cf(ga, gb, 5) * gw).sum().backward()
    (corr.correlation_cf_plain(pa, pb, 5) * gw).sum().backward()
    e_grad = max(rel_err(ga.grad, pa.grad)[0], rel_err(gb.grad, pb.grad)[0])
    log(f"B4 gradient w.r.t. a and b vs the twin's: max_abs_err {e_grad:.4g}")
    check(e_grad <= 1e-5, f"correlation_cf gradient disagrees: {e_grad}")
    res["correlation_cf"] = {
        "max_abs_err": err,
        "plain_ms": cuda_time_ms(lambda: corr.correlation_cf_plain(a, b, 5))}
    res["correlation_cf"]["bound_ms"], res["correlation_cf"]["bound_by"] = \
        bound(2 * px * 121 * 32, PEAK_F32, nbytes(a, b) + px * 121 * 4)
    autograd_checks(dev, res, a, b, w, ws, bs, xs)
    for name, t in kernel_times(dev, inp).items():
        res[name].update(t)
    return res


def kernel_lines(res, card):
    """One line per kernel: its time through the wrapper, its device time
    and host time per call, its bound and the bound's share of the device
    time, the library call's times and the twin's."""
    lines = []
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f} "
            f"ms, host {r['library_host_us']:.1f} us")
        lines.append(
            f"{name}: kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
            f"ms, host {r['host_us']:.1f} us per call, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
            f"{r['bound_ms'] / r['device_ms']:.3f}, library {lib}, plain "
            f"{r['plain_ms']:.4f} ms on {card}")
    return lines


NMS_SIZES = {300: (1, 2), 1200: (2,), 4096: (2,)}   # N: leading rows


def nms_kernel_checks(dev):
    """The exact NMS's fixpoint kernel against its plain loop, bit for
    bit, at the main paths' N (NMS_SIZES: the second stage's final NMS
    over (B, F) = (1, 2) rows, the RPN's over two frame rows at eval and
    in training), on clustered car-sized boxes with tied scores; timed()
    beside the plain loop (one host sync a pass), bound by the bytes of
    the dominance matrix. Returns the N = 300 numbers and ``by_n``."""
    import torch
    from dodt_tpu_torch.ops import nms
    by_n = {}
    for n, lead in NMS_SIZES.items():
        g = torch.Generator().manual_seed(n)
        centres = torch.rand(lead + (n // 8 + 1, 2), generator=g) * 0.9 + 0.05
        pick = torch.randint(0, centres.shape[-2], lead + (n,), generator=g)
        c = torch.gather(centres, -2, pick[..., None].expand(lead + (n, 2)))
        c = c + 0.01 * torch.randn(lead + (n, 2), generator=g)
        half = (torch.rand(lead + (n, 2), generator=g) * 2.0 + 1.0) / 70.0
        boxes = torch.cat([c - half, c + half], -1).to(dev)
        scores = (torch.round(torch.rand(lead + (n,), generator=g) * 16)
                  / 16).to(dev)
        valid = (torch.rand(lead + (n,), generator=g) > 0.2).to(dev)
        _, dom = nms._dominance(boxes, scores, valid, 0.01)
        got, want = nms.fixpoint(dom), nms.fixpoint_plain(dom)
        check(torch.equal(got, want),
              f"the NMS fixpoint kernel differs from its plain loop at {n}")
        passes = 0
        supp = torch.zeros_like(want)
        while True:
            new = (dom & ~supp[..., None, :]).any(dim=-1)
            passes += 1
            if torch.equal(new, supp):
                break
            supp = new
        r = timed(lambda: nms.fixpoint(dom))
        r["plain_ms"] = cuda_time_ms(lambda: nms.fixpoint_plain(dom))
        r["bound_ms"], r["bound_by"] = bound(0, PEAK_F32,
                                             nbytes(dom, got))
        r["passes"] = passes
        r["rows"] = int(got.numel() // n)
        by_n[n] = r
        log(f"nms fixpoint N = {n}, {r['rows']} rows, {passes} passes: "
            f"kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms")
    return {**by_n[300], "max_abs_err": 0.0, "library_ms": None,
            "by_n": by_n}


def second_stage_times(model, batch, n=10):
    """The pair stage's second stage at full width on two encoded frames,
    eager (``_second_stage`` on the stacked states, as before the graph)
    and replayed (``pair_stage``), the replay bit-equal to the eager
    call: per arm the median over n calls of the host's ms to issue a
    call and of the call's ms to a synchronize (timed()'s sleep cannot
    hold the eager stage: its hundreds of launches fill the card's
    queue)."""
    import torch
    from dodt_tpu_torch.models.dt_avod import FINAL_KEYS
    dev = next(model.parameters()).device
    a, b = (model.encode_frame({k: torch.as_tensor(v, device=dev)
                                for k, v in f.items()})
            for f in frames_of(batch))
    keys = ("bev_feats", "img_feats", "top_anchors", "top_valid")

    @torch.no_grad()
    def eager():
        return model._second_stage(
            *(torch.stack([a[k], b[k]], 1) for k in keys),
            a["ground_plane"], a["p2"], a["orig_image_shape"].float(), 0.0)

    want = eager()
    got = model.pair_stage(a, b)
    for k in FINAL_KEYS:
        check(torch.equal(got[k], want[k]),
              f"the replayed pair stage's {k} differs from the eager one")
    res = {}
    for arm, fn in (("eager", eager),
                    ("replayed", lambda: model.pair_stage(a, b))):
        host, synced = [], []
        for i in range(n + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:
                host.append((t1 - t0) * 1e3)
                synced.append((t2 - t0) * 1e3)
        res[arm] = {"host_ms": float(np.median(host)),
                    "ms": float(np.median(synced))}
    log(f"second stage eager {res['eager']}, replayed {res['replayed']}")
    return res


def twin_vjp(a, b, weights, grad, max_displacement, stride_2=1):
    """B3's other backward route: the twin's autograd recomputed from the
    inputs (the port's B3 backward before corr_bottleneck_vjp)."""
    import torch
    from dodt_tpu_torch.ops import correlation as corr
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (a, b, weights)]
        out = corr.corr_bottleneck_plain(
            *leaves, max_displacement, stride_2,
            corr.grid_origin(max_displacement, stride_2))
        return torch.autograd.grad(out, leaves, grad)


def autograd_checks(dev, res, a, b, w, ws, bs, xs):
    """B3's and B1's autograd routes against the twins' autograd at the
    main-path shapes, to the forward tolerances: B3's kernel forward with
    its backward through the blur form (corr_bottleneck_vjp), B1's kernel
    forward with the twin's autograd backward. B3's route again with
    cudnn.allow_tf32 True (PyTorch's default; the script runs with it
    False), to the same bound. B3's two backward routes
    timed alike (CUDA events): the blur VJP, which the route takes
    (``bwd_ms``), and the twin's autograd (``bwd_ms_twin``); and the
    route's forward + backward less its forward."""
    import torch
    from dodt_tpu_torch.ops import conv_chain as cc
    from dodt_tpu_torch.ops import correlation as corr
    g = torch.Generator().manual_seed(4)
    cot = torch.randn((1, 1, 350, 400), generator=g).to(dev)
    kern = [t.detach().clone().requires_grad_() for t in (a, b, w)]
    out = corr.corr_bottleneck(*kern, 5)
    check(out.grad_fn is not None, "corr_bottleneck output has no grad_fn")
    (out * cot).sum().backward()
    twin = [t.detach().clone().requires_grad_() for t in (a, b, w)]
    (corr.corr_bottleneck_plain(*twin, 5) * cot).sum().backward()
    for name, k, p in zip(("a", "b", "weights"), kern, twin):
        e, scale = rel_err(k.grad, p.grad)
        log(f"B3 gradient w.r.t. {name} (blur VJP) vs the twin's autograd: "
            f"max_abs_err {e:.4g} (max |ref| {scale:.4g})")
        check(e <= 1e-4 * scale, f"corr_bottleneck grad {name}: {e}")
    # again at PyTorch's default cudnn.allow_tf32 (True), which the
    # port's entry points (Trainer, cli train) run under: the blur VJP's
    # convs are cuDNN's, so their precision is cuDNN's choice there
    tf32 = [t.detach().clone().requires_grad_() for t in (a, b, w)]
    torch.backends.cudnn.allow_tf32 = True
    try:
        (corr.corr_bottleneck(*tf32, 5) * cot).sum().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    errs = []
    for name, k, p in zip(("a", "b", "weights"), tf32, twin):
        e, scale = rel_err(k.grad, p.grad)
        errs.append(e / scale)
        log(f"B3 gradient w.r.t. {name} (blur VJP, cudnn.allow_tf32 True) "
            f"vs the twin's autograd: max_abs_err {e:.4g} (max |ref| "
            f"{scale:.4g})")
        check(e <= 1e-4 * scale,
              f"corr_bottleneck grad {name} with TF32 allowed: {e}")
    res["corr_bottleneck"]["bwd_rel_err_tf32"] = max(errs)

    def fwd():
        return corr.corr_bottleneck(*kern, 5)

    def fwd_bwd():
        torch.autograd.grad(corr.corr_bottleneck(*kern, 5), kern, cot)
    f_ms = cuda_time_ms(fwd, n_timed=5)
    fb_ms = cuda_time_ms(fwd_bwd, n_timed=5)
    bwd = {route: cuda_time_ms(lambda fn=fn: fn(a, b, w, cot, 5), n_timed=5)
           for route, fn in (("blur", corr.corr_bottleneck_vjp),
                             ("twin", twin_vjp))}
    res["corr_bottleneck"]["bwd_ms"] = bwd["blur"]
    res["corr_bottleneck"]["bwd_ms_twin"] = bwd["twin"]
    # the backward's least work: for each of the 121 displacements and
    # every pixel, C multiply-adds for each of grad a (the displaced B
    # under w . grad), grad b (the same stencil reversed) and grad w (the
    # correlation itself), and one more for w . grad and for the weight
    # gradient's reduce; a, b, w and grad read once, the three gradients
    # written once
    px, c = a.shape[1] * a.shape[2], a.shape[3]
    res["corr_bottleneck"]["bwd_bound_ms"], \
        res["corr_bottleneck"]["bwd_bound_by"] = bound(
            2 * px * 121 * (3 * c + 2), PEAK_F32,
            2 * nbytes(a, b, w) + nbytes(cot))
    log(f"B3 at (1, 350, 400, 32): forward {f_ms:.4f} ms; backward "
        f"through the blur VJP (the route) {bwd['blur']:.4f} ms, through "
        f"the twin's autograd {bwd['twin']:.4f} ms, bound "
        f"{res['corr_bottleneck']['bwd_bound_ms']:.4f} ms "
        f"({res['corr_bottleneck']['bwd_bound_by']}); the route's forward "
        f"+ backward less its forward {fb_ms - f_ms:.4f} ms")

    # B1: the conv4 chain's gradients w.r.t. the input and every weight
    x = xs[0].detach().clone().requires_grad_()
    kw = [t.detach().clone().requires_grad_() for t in (*ws, *bs)]
    out = cc.conv_chain(x, kw[:3], kw[3:])
    check(out.grad_fn is not None, "conv_chain output has no grad_fn")
    cot = torch.randn(out.shape, generator=g).to(dev)
    (out.float() * cot).sum().backward()
    px = xs[0].detach().clone().requires_grad_()
    pw = [t.detach().clone().requires_grad_() for t in (*ws, *bs)]
    (cc.conv_chain_plain(px, pw[:3], pw[3:]).float() * cot).sum().backward()
    worst = 0.0
    for k, p in zip([x, *kw], [px, *pw]):
        e, scale = rel_err(k.grad, p.grad)
        worst = max(worst, e / max(scale, 1e-30))
        # the backward recomputes the twin from the same inputs: only
        # the f32 sum order of cuDNN's algorithms may differ
        check(e <= 2e-2 * scale, f"conv_chain grad disagrees: {e} vs {scale}")
    log(f"B1 gradients w.r.t. x and 6 parameters vs the twin's: worst "
        f"max_abs_err / max |ref| {worst:.4g}")


# ---------------------------------------------------------------- phase 3

def frames_of(batch):
    return [{"points": batch["points"][:, i],
             "points_valid": batch["points_valid"][:, i],
             "image": batch["image"][:, i],
             "ground_plane": batch["ground_plane"], "p2": batch["p2"],
             "orig_image_shape": batch["orig_image_shape"]}
            for i in range(2)]


def ego_motion():
    """bench.py's moving platform: 1.2 m/frame x tau=3, 0.5 deg yaw."""
    th = np.radians(0.5)
    a2 = np.array([[np.cos(th), -np.sin(th)],
                   [np.sin(th), np.cos(th)]], np.float32)
    return a2, np.array([0.05, 3.6], np.float32)


def check_outputs(out, k_final):
    import torch
    shapes = {"final_boxes_3d": (1, 2, k_final, 7),
              "final_scores": (1, 2, k_final),
              "final_valid": (1, 2, k_final),
              "final_corr_offsets": (1, k_final, 3)}
    for key, shape in shapes.items():
        v = out[key]
        check(tuple(v.shape) == shape, f"{key} shape {tuple(v.shape)}")
        if v.dtype != torch.bool:
            check(bool(torch.isfinite(v).all()), f"{key} not finite")


def full_width(dev):
    """cars_dt_tracking at 65536 points on the card, seeded weights, and
    make_batch's couple (host arrays)."""
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params

    cfg = cars_dt_tracking()
    cfg.dataset.max_points = 65536
    model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    return cfg, model.to(dev).eval(), make_batch(cfg,
                                                 np.random.RandomState(0))


def full_slice(cfg, model, batch, counters):
    """Full-width cars_dt_tracking keyframes on both arms."""
    import torch
    from dodt_tpu_torch.runtime.predictor import StreamingPredictor

    dev = next(model.parameters()).device
    frames = frames_of(batch)
    pred = StreamingPredictor(model)

    for c in counters:
        c.launches = 0
    times, out, n_valid, pushes = {}, None, {}, 0
    for arm, ego in (("static", None), ("ego", ego_motion())):
        pred.reset()
        pred.push_keyframe(frames[0], fetch=False)
        pushes += 1 + N_WARM + 3 * N_TIMED
        for i in range(N_WARM):
            out = pred.push_keyframe(frames[(i + 1) % 2], fetch=False,
                                     ego_to_prev=ego)
        # the host launches and syncs most of the keyframe, so its time
        # spreads: median of three rounds, each a mean over N_TIMED
        rounds = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_TIMED):
                out = pred.push_keyframe(frames[i % 2], fetch=False,
                                         ego_to_prev=ego)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / N_TIMED * 1e3)
            check_outputs(out, cfg.model.avod.nms_size)
        times[arm] = float(np.median(rounds))
        log(f"full slice {arm} arm: keyframe ms per round {rounds}")
        n_valid[arm] = int(out["final_valid"].sum())
    launches = {c.symbol: c.launches for c in counters}
    log(f"full slice: steady keyframe ms {times}, valid finals {n_valid}, "
        f"launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    for sym, n in launches.items():
        check(n > 0, f"kernel {sym} was not launched on the main path")
    # one more keyframe with its aten ops counted: B2 runs once, on the
    # f32 maps as they are (its wrapper no longer casts them to bf16)
    b2 = next(c for c in counters if c.symbol == "dodt_roi_window")
    before = b2.launches
    casts = count_map_casts(lambda: pred.push_keyframe(
        frames[0], fetch=False, ego_to_prev=ego_motion()))
    log(f"one keyframe: B2 launched {b2.launches - before} time(s), casts "
        f"of a whole f32 feature map to bf16: {len(casts)} {casts}")
    check(b2.launches - before == 1, "B2 did not run once per keyframe")
    check(not casts, f"the keyframe cast f32 feature maps {casts} to bf16")
    return times, launches, pushes


def count_map_casts(fn, map_hwc=(350, 400, 32)):
    """Run fn(); the shapes of the f32 tensors whose last three axes are
    a whole feature map's (H, W, C) (the full-width BEV features by
    default) that it cast to bf16, one per aten cast."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    casts = []

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func is torch.ops.aten._to_copy.default
                    and kwargs.get("dtype") == torch.bfloat16
                    and args[0].dtype == torch.float32
                    and tuple(args[0].shape[-3:]) == map_hwc):
                casts.append(tuple(args[0].shape))
            return func(*args, **kwargs)

    with Casts():
        fn()
    return casts


# ---------------------------------------------------------------- phase 4

def small_cfg():
    from dodt_tpu_torch.config import unittest_pipeline
    cfg = unittest_pipeline()
    cfg.dataset.kitti_utils.area_extents = ((-16.0, 16.0), (-3.0, 3.0),
                                            (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.model.rpn.fusion_top_k = 1024       # two-pass fusion, like the
    cfg.model.tower_dtype = "bfloat16"      # flagship; 240x160 BEV feats
    return cfg                              # fit the 64-px crop window


def matched_fraction(got, want, valid_got, valid_want, tol):
    """Share of valid rows of got with a valid row of want within tol
    (max abs over the last axis); rows may come in another order."""
    g = got.float().cpu()[valid_got.cpu()]
    w = want.float().cpu()[valid_want.cpu()]
    if len(g) == 0:
        return 1.0 if len(w) == 0 else 0.0
    if len(w) == 0:
        return 0.0
    d = (g[:, None, :] - w[None, :, :]).abs().amax(-1)
    return float((d.amin(1) <= tol).float().mean())


def cuda_vs_cpu(dev):
    """The small slice on the card against the same slice on the CPU."""
    import copy
    import torch
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import (DtAvodNet, bev_crop_fn,
                                               init_params)
    from dodt_tpu_torch.ops.projection import (project_to_bev,
                                               reorder_boxes_yx)
    from dodt_tpu_torch.ops.roi import crop_and_resize_gather
    from dodt_tpu_torch.ops.roi_window import window_fits
    from dodt_tpu_torch.runtime.predictor import StreamingPredictor

    cfg = small_cfg()
    clusters = ((3.9, 1.6, 1.52),)
    cpu_model = DtAvodNet(cfg, clusters)
    init_params(cpu_model, torch.Generator().manual_seed(1))
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    frames = frames_of(make_batch(cfg, np.random.RandomState(1)))

    def to(d, frame):
        return {k: torch.as_tensor(v, device=d) for k, v in frame.items()}

    st_g = gpu_model.encode_frame(to(dev, frames[0]))
    st_c = cpu_model.encode_frame(to("cpu", frames[0]))
    e, scale = rel_err(st_g["bev_feats"].cpu(), st_c["bev_feats"])
    log(f"small slice bev_feats: max_abs_err {e:.4g} (max |ref| {scale:.4g})")
    # bf16 towers on both; cuDNN, the CPU convs and kernel B1 round at
    # the same places but sum in other orders: 3e-2 of the range
    check(e <= 3e-2 * scale, f"bev_feats CUDA vs CPU {e} vs {scale}")
    frac = matched_fraction(st_g["top_anchors"][0], st_c["top_anchors"][0],
                            st_g["top_valid"][0].cpu(), st_c["top_valid"][0],
                            0.05)
    log(f"small slice top_anchors matched within 0.05 m: {frac:.3f}")
    # rounding noise may reorder near-tied RPN scores, moving a few
    # proposals in or out of the top-k: require 90% to match
    check(frac >= 0.9, f"top_anchors CUDA vs CPU matched {frac}")

    # window crop == gather crop for the proposals that fit the window
    ku = cfg.dataset.kitti_utils
    m = cfg.model
    feats = st_g["bev_feats"]
    _, norm = project_to_bev(st_g["top_anchors"], ku.bev_extents)
    yx = reorder_boxes_yx(norm)
    crop = bev_crop_fn(m.avod.proposal_roi_crop_size, m.avod.bev_roi_window,
                       False, feats.shape[1:], feats.device)
    win = crop(feats, yx)[0]
    gat = crop_and_resize_gather(feats[0], yx[0], m.avod.proposal_roi_crop_size)
    fits = window_fits(feats.shape, yx, m.avod.proposal_roi_crop_size,
                       m.avod.bev_roi_window)[0]
    check(bool(fits.any()), "no proposal fits the crop window")
    e, scale = rel_err(win[fits], gat[fits])
    log(f"small slice window vs gather on {int(fits.sum())} fitting ROIs: "
        f"max_abs_err {e:.4g} (max |ref| {scale:.4g})")
    check(e <= 2e-2 * scale, f"window crop vs gather {e}")

    # the pair stage (and the predictor's ego warp) on identical states:
    # both frames encoded on the card, copied to the CPU
    st1_g = gpu_model.encode_frame(to(dev, frames[1]))
    for arm, ego in (("static", None), ("ego", ego_motion())):
        outs = {}
        for name, model, d in (("cuda", gpu_model, dev),
                               ("cpu", cpu_model, "cpu")):
            prev = {k: v.to(d) for k, v in st_g.items()}
            cur = {k: v.to(d) for k, v in st1_g.items()}
            if ego is not None:
                cur = StreamingPredictor(model, device=d).warp_state(
                    cur, *(torch.as_tensor(v, device=d) for v in ego))
            outs[name] = model.pair_stage(prev, cur)
        og, oc = outs["cuda"], outs["cpu"]
        vg, vc = og["final_valid"].cpu(), oc["final_valid"]
        boxes = matched_fraction(og["final_boxes_3d"].reshape(-1, 7),
                                 oc["final_boxes_3d"].reshape(-1, 7),
                                 vg.reshape(-1), vc.reshape(-1), 0.1)
        log(f"small slice {arm}: valid finals cuda {int(vg.sum())} cpu "
            f"{int(vc.sum())}, boxes matched within 0.1: {boxes:.3f}")
        check(abs(int(vg.sum()) - int(vc.sum())) <= max(2, vc.sum() // 10),
              f"{arm}: valid final counts differ")
        check(boxes >= 0.9, f"{arm}: final boxes CUDA vs CPU matched {boxes}")


# ---------------------------------------------------------------- phase 5

# every output of the JAX DtAvodNet.__call__ in val mode
FORWARD_KEYS = (
    "anchors", "anchor_valid", "bev_input", "img_mask", "bev_mask",
    "objectness", "rpn_offsets", "top_anchors", "top_scores", "top_valid",
    "proposal_boxes_3d", "proposal_enc", "cls_logits", "box_offsets",
    "angle_vectors", "pred_boxes_3d", "pred_orientations", "final_indices",
    "final_valid", "final_boxes_3d", "final_orientations",
    "final_cls_softmax", "final_scores", "corr_pred", "final_corr_offsets")


def check_forward(out, b, cfg):
    import torch
    m = cfg.model
    k, k_final = m.rpn.test_nms_size, m.avod.nms_size
    check(set(out) == set(FORWARD_KEYS), f"forward keys {sorted(out)}")
    shapes = {"top_anchors": (b, 2, k, 6), "top_valid": (b, 2, k),
              "cls_logits": (b, 2, k, len(cfg.dataset.classes) + 1),
              "corr_pred": (b, k, 3), "final_boxes_3d": (b, 2, k_final, 7),
              "final_scores": (b, 2, k_final),
              "final_valid": (b, 2, k_final),
              "final_corr_offsets": (b, k_final, 3)}
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape,
              f"{key} shape {tuple(out[key].shape)}")
    for key, v in out.items():
        if v is not None and v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{key} not finite")


def pair_forward(cfg, model, batch, counters):
    """The full-width monolithic forward, B = 1 couple: launches of B1-B3
    in this phase alone, and bench.py's pair_latency_ms methodology
    (warm-up, N_TIMED calls, one sync), median of three rounds."""
    import torch
    dev = next(model.parameters()).device
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    for c in counters:
        c.launches = 0
    out = model(tb)
    torch.cuda.synchronize()
    check_forward(out, 1, cfg)
    n_valid = int(out["final_valid"].sum())
    for _ in range(N_WARM - 1):
        model(tb)
    rounds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            out = model(tb)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / N_TIMED * 1e3)
    check_forward(out, 1, cfg)
    launches = {c.symbol: c.launches for c in counters}
    log(f"pair forward: ms per round {rounds}, valid finals {n_valid}, "
        f"launches {launches}")
    for sym, n in launches.items():
        check(n > 0, f"kernel {sym} was not launched by the pair forward")
    return float(np.median(rounds)), launches, N_WARM + 3 * N_TIMED


def correlation_op(dev, counter):
    """B4's own path: the public ops on two full-width BEV feature maps."""
    import torch
    from dodt_tpu_torch.ops import correlation as corr
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn((1, 350, 400, 32), generator=g).to(dev)
            for _ in range(2))
    counter.launches = 0
    vol = corr.correlation(a, b, 5)
    torch.cuda.synchronize()
    launches = counter.launches
    check(tuple(vol.shape) == (1, 350, 400, 121), f"correlation {vol.shape}")
    check(bool(torch.isfinite(vol).all()), "correlation not finite")
    # the centre displacement is the plain per-pixel dot product / C
    centre = (a * b).sum(-1) / 32
    e, scale = rel_err(vol[..., 60], centre)
    log(f"B4 public op: {launches} launches, centre displacement vs "
        f"sum(a * b) / C max_abs_err {e:.4g} (max |ref| {scale:.4g})")
    check(launches > 0, "correlation launched no kernel")
    check(e <= 1e-5 * scale, f"correlation centre displacement {e}")
    return launches


# ---------------------------------------------------------------- phase 6

def forward_cuda_vs_cpu(dev):
    """The small config's monolithic forward at B = 2 on the card against
    the same forward on the CPU (B1 at batch 4, B2 over 4 maps)."""
    import copy
    import torch
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params

    cfg = small_cfg()
    cpu_model = DtAvodNet(cfg, ((3.9, 1.6, 1.52),))
    init_params(cpu_model, torch.Generator().manual_seed(1))
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    parts = [make_batch(cfg, np.random.RandomState(s)) for s in (1, 2)]
    host = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    og = gpu_model({k: torch.as_tensor(v, device=dev)
                    for k, v in host.items()})
    oc = cpu_model({k: torch.as_tensor(v) for k, v in host.items()})
    check_forward(og, 2, cfg)
    e, scale = rel_err(og["bev_input"].cpu(), oc["bev_input"])
    log(f"forward bev_input CUDA vs CPU: max_abs_err {e:.4g}")
    check(e <= 1e-5 * max(scale, 1.0), f"bev_input CUDA vs CPU {e}")
    check(torch.equal(og["anchor_valid"].cpu(), oc["anchor_valid"]),
          "anchor_valid CUDA vs CPU differ")
    for b in range(2):
        for f in range(2):
            top = matched_fraction(
                og["top_anchors"][b, f], oc["top_anchors"][b, f],
                og["top_valid"][b, f].cpu(), oc["top_valid"][b, f], 0.05)
            vg = og["final_valid"][b, f].cpu()
            vc = oc["final_valid"][b, f]
            fin = matched_fraction(og["final_boxes_3d"][b, f],
                                   oc["final_boxes_3d"][b, f], vg, vc, 0.1)
            log(f"forward couple {b} frame {f}: top_anchors matched "
                f"{top:.3f}, valid finals cuda {int(vg.sum())} cpu "
                f"{int(vc.sum())}, final boxes matched {fin:.3f}")
            # as in phase 4: bf16 rounding noise may reorder near-tied
            # scores and move a few proposals, and with them finals
            check(top >= 0.9, f"couple {b} frame {f}: top_anchors {top}")
            check(abs(int(vg.sum()) - int(vc.sum())) <= max(2, vc.sum() // 10),
                  f"couple {b} frame {f}: valid final counts differ")
            check(fin >= 0.8, f"couple {b} frame {f}: final boxes {fin}")


# ---------------------------------------------------------------- phase 7

def car_boxes(rng, n, ground_y):
    """n non-overlapping car boxes (box_3d, camera frame) on a 4-column
    grid in front of the sensor, sizes near the car clusters."""
    cols = 4
    rows = (n + cols - 1) // cols
    gx = np.linspace(-15.0, 15.0, cols)
    gz = np.linspace(12.0, 12.0 + 6.0 * (rows - 1), rows)
    xs, zs = np.meshgrid(gx, gz)
    xs, zs = xs.ravel()[:n], zs.ravel()[:n]
    l = rng.uniform(3.6, 4.2, n)
    w = rng.uniform(1.55, 1.7, n)
    h = rng.uniform(1.45, 1.6, n)
    ry = rng.choice([0.0, -np.pi / 2], n) + rng.uniform(-0.1, 0.1, n)
    return np.stack([xs + rng.uniform(-0.5, 0.5, n), np.full(n, ground_y),
                     zs + rng.uniform(-0.5, 0.5, n), l, w, h, ry],
                    -1).astype(np.float32)


def car_surface_points(rng, box, k):
    """k points on the four sides and the roof of one box_3d."""
    x, y, z, l, w, h, ry = box
    face = rng.randint(0, 5, k)
    u = rng.uniform(-0.5, 0.5, k) * l
    v = rng.uniform(-0.5, 0.5, k) * w
    u = np.where(face == 0, l / 2, np.where(face == 1, -l / 2, u))
    v = np.where(face == 2, w / 2, np.where(face == 3, -w / 2, v))
    up = np.where(face == 4, h, rng.uniform(0.2, 1.0, k) * h)
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([x + u * c + v * s, y - up, z - u * s + v * c],
                    -1).astype(np.float32)


def train_batch(cfg, rng):
    """make_batch's couple with seeded GT in the dataset's keys
    (dodt_tpu/data/tracking.py): two cars per frame, whose surface
    points overwrite both frames' scans. Random RPN weights score
    anchors arbitrarily, so the second stage holds a positive only if
    every non-empty anchor fits the 1024 proposals: two cars leave about
    960 non-empty anchors (one stray scan point validates every anchor
    around it: with the scan kept, 52k), of which about 6 per frame
    pass the second stage's 0.65 IoU and 27 the RPN's 0.5."""
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    batch = make_batch(cfg, rng)
    g, n_gt = cfg.dataset.max_gt_boxes, 2
    boxes = car_boxes(rng, n_gt, float(batch["ground_plane"][0, 3]))
    p = batch["points"].shape[2]
    pts_per_car = p // n_gt
    idx = rng.permutation(p)[:n_gt * pts_per_car]
    for f in range(2):
        car = np.concatenate([car_surface_points(rng, bx, pts_per_car)
                              for bx in boxes])
        batch["points"][0, f, idx] = car
    gt = np.zeros((1, 2, g, 7), np.float32)
    gt[0, :, :n_gt] = boxes
    valid = np.zeros((1, 2, g), bool)
    valid[0, :, :n_gt] = True
    batch.update({
        "gt_boxes": gt, "gt_classes": valid.astype(np.int32),
        "gt_valid": valid,
        "gt_track_ids": np.where(valid, np.arange(g), -1).astype(np.int32),
        "corr_offsets": np.where(valid[0, :1, :, None], rng.uniform(
            -0.5, 0.5, (1, g, 3)), 0.0).astype(np.float32),
        "corr_coexist": valid[:, 0].copy()})
    return batch


class SmokeStream:
    """An in-memory dataset for the Trainer: next_batch gives
    train_batch's couple from a seeded generator, a new one each call."""

    def __init__(self, cfg, seed):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)

    def next_batch(self, batch_size, augment=True):
        parts = [train_batch(self.cfg, self.rng) for _ in range(batch_size)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


TRAIN_STEPS = 6
LOSS_KEYS = ("rpn_cls", "rpn_reg", "avod_cls", "avod_reg", "avod_ang",
             "corr", "total")


def full_width_training(dev, counters):
    """cars_dt_tracking at full width, B = 1 couple, train=True (dropout,
    path drop, sampling), through Trainer.train. The random weights are
    init_params' with rpn_reg's output layer scaled by 1e-2: a trained
    RPN regresses small offsets, and random ones would move every
    proposal off its anchor, so the second stage would see no positive.
    One step's gradients are checked first: twice from one state with
    the same draws, bit-equal in every leaf; finite everywhere, non-zero
    for B3's weights. Then the counters are zeroed and the Trainer runs
    TRAIN_STEPS steps. Returns (median step ms, peak MiB, launches, the
    checkpoint directory, which phase 9 evaluates and then removes, and
    the count of gradient leaves that differed between the two
    runs)."""
    import shutil
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import (DtAvodNet, compute_losses,
                                               generator_draws, init_params)
    from dodt_tpu_torch.runtime.trainer import Trainer

    cfg = cars_dt_tracking()
    cfg.dataset.max_points = 65536
    n_steps = TRAIN_STEPS
    cfg.train.checkpoint_interval = n_steps
    model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.rpn_reg.out.weight.mul_(1e-2)
    model.to(dev).train()

    stream = SmokeStream(cfg, 7)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.next_batch(1).items()}

    def backward():
        """The step's gradients from the model's state, the draws of one
        seeded generator."""
        rand = generator_draws(torch.Generator(dev).manual_seed(1))
        out = model(batch, mode="train", train=True, rand=rand)
        _, losses = compute_losses(cfg, out, batch, rand)
        losses["total"].backward()
        return out, losses

    # twice from one state with the same draws, deterministic algorithms
    # off (PyTorch's default, as Trainer runs): every leaf bit-equal
    backward()
    first = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    out, losses = backward()
    differ = [n for n, p in model.named_parameters()
              if p.grad is not None and not torch.equal(p.grad, first[n])]
    log(f"train step gradients twice from one state (same draws, "
        f"deterministic algorithms off): {len(differ)} of {len(first)} "
        f"leaves differ {differ[:8]}")
    check(not differ and len(first) == sum(
        p.grad is not None for p in model.parameters()),
        f"gradients not reproducible: {differ}")
    del first
    log("first train step losses: " + ", ".join(
        f"{k} {losses[k].item():.4g}" for k in LOSS_KEYS) + ", valid "
        f"proposals per frame {out['top_valid'].sum(-1).tolist()}")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not bad, f"parameters without a finite gradient: {bad}")
    gw = float(model.bev_corr_bottleneck.weight.grad.abs().max())
    log(f"train step gradients: all {len(list(model.parameters()))} finite, "
        f"max |d/d bev_corr_bottleneck.weight| {gw:.4g}")
    check(gw > 0, "bev_corr_bottleneck.weight got no gradient")
    model.zero_grad(set_to_none=True)
    del out, losses

    ckpt = os.path.join(ROOT, "build", "smoke_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    trainer = Trainer(cfg, model, stream, ckpt, metrics_path=None)
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    state, history = trainer.train(max_steps=n_steps, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.symbol: c.launches for c in counters}
    steps_ms = np.diff([0.0] + [h["wall_s"] for h in history]) * 1e3
    for h in history:
        log("train step {}: ".format(h["step"]) + ", ".join(
            f"{k} {h[k]:.4g}" for k in LOSS_KEYS))
    check(state.step == n_steps and trainer.ckpt.all_steps() == [n_steps],
          f"trainer ended at step {state.step}")
    for k in LOSS_KEYS:
        vals = [h[k] for h in history]
        check(all(np.isfinite(vals)), f"loss {k} not finite: {vals}")
        check(np.mean(vals) > 0, f"loss {k} is zero in every step")
    check(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
          "parameters not finite after training")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    med = float(np.median(steps_ms[1:]))
    log(f"full-width training: {n_steps} steps in {wall:.2f} s, step ms "
        f"{[round(float(t), 2) for t in steps_ms]}, median after the first "
        f"{med:.2f} ms, peak device memory {peak:.0f} MiB, launches "
        f"{launches}")
    b1, b2, b3 = (launches[c.symbol] for c in counters[:3])
    check(b3 > 0, "corr_bottleneck (B3) was not launched by training")
    check(b1 == 0 and b2 == 0, "an eval-only kernel (B1/B2) ran in training")
    return med, peak, launches, ckpt, len(differ)


# ---------------------------------------------------------------- phase 8

def train_step_cuda_vs_cpu(dev):
    """One train step of the small config (f32 towers, two-pass RPN,
    dropout and path drop off) on the card and on the CPU, with the same
    weights, batch and sampling draws. SGD at lr 1 with no clipping, so
    each parameter's update is minus its gradient: the losses and every
    gradient are compared."""
    import copy
    import torch
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models import dt_avod
    from dodt_tpu_torch.runtime.trainer import (create_train_state,
                                                make_train_step)

    cfg = small_cfg()
    cfg.model.tower_dtype = "float32"
    cfg.model.rpn.keep_prob = cfg.model.avod.keep_prob = 1.0
    cfg.model.path_drop_probabilities = (1.0, 1.0)
    opt = cfg.train.optimizer
    opt.name, opt.initial_lr, opt.grad_clip_norm = "sgd", 1.0, 1e30
    clusters = ((3.9, 1.6, 1.52),)
    cpu_model = dt_avod.DtAvodNet(cfg, clusters)
    dt_avod.init_params(cpu_model, torch.Generator().manual_seed(2))
    with torch.no_grad():              # proposals near anchors (phase 7)
        cpu_model.rpn_reg.out.weight.mul_(1e-2)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    host = make_batch(cfg, np.random.RandomState(3))
    cache = {}
    g = torch.Generator().manual_seed(4)

    def rand(name, shape):                       # the same draws for both
        if (name, shape) not in cache:
            cache[name, shape] = torch.rand(shape, generator=g)
        return cache[name, shape]

    # GT on the CPU forward's first proposals: every loss term non-zero
    cpu_batch = {k: torch.as_tensor(v) for k, v in host.items()}
    with torch.no_grad():
        out = cpu_model(cpu_batch, mode="train", rand=rand)
    top, top_valid = out["top_anchors"], out["top_valid"]
    gmax = cfg.dataset.max_gt_boxes
    boxes = dt_avod.box_ops.anchors_to_box_3d(top[:, :, :gmax], fix_lw=True)
    host["gt_boxes"] = boxes.numpy() + np.float32([0.05, 0, 0, 0, 0, 0, 0])
    host["gt_valid"] = out_valid = top_valid[:, :, :gmax].numpy()
    host["gt_classes"] = out_valid.astype(np.int32)
    host["corr_offsets"] = np.random.RandomState(5).uniform(
        -0.5, 0.5, (1, gmax, 3)).astype(np.float32)
    host["corr_coexist"] = np.ones((1, gmax), bool)
    results = {}
    for name, model, d in (("cpu", cpu_model, "cpu"),
                           ("cuda", gpu_model, dev)):
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, model)
        batch = {k: torch.as_tensor(v, device=d) for k, v in host.items()}
        new, losses = step(state, batch, lambda n, s, d=d: rand(n, s).to(d))
        grads = {k: (state.params[k] - new.params[k]).cpu()
                 for k in state.params}
        results[name] = ({k: float(v) for k, v in losses.items()}, grads)
    (lc, gc), (lg, gg) = results["cpu"], results["cuda"]
    log("small train step losses cuda " + ", ".join(
        f"{k} {lg[k]:.6g}" for k in LOSS_KEYS) + " | cpu " + ", ".join(
        f"{k} {lc[k]:.6g}" for k in LOSS_KEYS))
    for k in LOSS_KEYS:
        check(lc[k] > 0, f"small step: loss {k} is zero")
        # f32 with TF32 off: cuDNN/cuBLAS and index-add atomics sum in
        # other orders than the CPU: 1e-4 relative
        check(abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]),
              f"small step loss {k}: cuda {lg[k]} cpu {lc[k]}")
    top_grad = max(float(v.abs().max()) for v in gc.values())
    worst, worst_key = 0.0, None
    for k, want in gc.items():
        e, scale = rel_err(gg[k], want)
        # a bias ahead of a one-channel GroupNorm has an exact gradient
        # of 0: rounding noise on both sides, held to 1e-4 of the model's
        # largest gradient; every other leaf to 1e-3 of its own range
        tol = max(1e-3 * scale, 1e-4 * top_grad) if scale < 1e-4 * \
            top_grad else 1e-3 * scale
        check(e <= tol, f"small step gradient {k}: {e} vs {scale}")
        if scale >= 1e-4 * top_grad and e / scale > worst:
            worst, worst_key = e / scale, k
    log(f"small train step: {len(gc)} gradients, worst max_abs_err / "
        f"max |ref| {worst:.4g} ({worst_key})")


# ---------------------------------------------------------------- phase 9

EVAL_SPEEDS = (0.0, 0.5)       # a static video and an ego-motion video
EVAL_FRAMES = 10
RESULT_KEYS = {"step", "ap", "ap_per_class", "ap_05_per_class", "mot",
               "val_health"}


def write_eval_fixture(root, speeds, n_frames):
    """The lidar, calib, label, oxts, plane and split files that the
    port's write_tracking_fixture writes for videos of these ego speeds
    (4 cars each, seed 0), from the same SyntheticScene, without the
    PNGs: the card's machine has no cv2. Returns the scenes by video."""
    from dodt_tpu_torch.data import synthetic
    base = os.path.join(root, "training")
    for sub in ("calib", "label_02", "oxts"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    scenes, groups = {}, []
    for vid, speed in enumerate(speeds):
        scene = scenes[vid] = synthetic.SyntheticScene(vid, n_frames,
                                                       ego_speed=speed)
        vdir, pdir = (os.path.join(base, sub, f"{vid:04d}")
                      for sub in ("velodyne", "planes"))
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(pdir, exist_ok=True)
        for frame in range(n_frames):
            scene.point_cloud_at(frame).tofile(
                os.path.join(vdir, f"{frame:06d}.bin"))
            with open(os.path.join(pdir, f"{frame:06d}.txt"), "w") as f:
                f.write("# Plane\nWidth 4\nHeight 1\n"
                        f"0.0 -1.0 0.0 {synthetic.GROUND_Y}\n")
        groups.append("\n".join(f"{vid:04d}/{frame:06d}"
                                for frame in range(n_frames)))
        for sub, text in (("calib", synthetic._calib_text()),
                          ("label_02", "\n".join(scene.label_lines()) + "\n"),
                          ("oxts", "\n".join(scene.oxts_lines()) + "\n")):
            with open(os.path.join(base, sub, f"{vid:04d}.txt"), "w") as f:
                f.write(text)
    for split in ("train", "val", "trainval", "test"):
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write("\n\n".join(groups) + "\n")
    return scenes


def flat_card(img, image_shape):
    """(original (H, W), the resized image) of a constant camera image,
    resized with numpy: a constant image resizes exactly, as cv2 would."""
    check(bool((img == img[0, 0]).all()),
          "the fixture's camera image is not constant")
    ih, iw = image_shape
    return img.shape[:2], np.broadcast_to(img[0, 0], (ih, iw, 3)).copy()


def eval_dataset(cfg, scenes, base=None):
    """The port's KittiTrackingDataset (or ``base``, a subclass such as
    KittiTrackingStackDataset; val split) over write_eval_fixture's
    files, its camera images the scenes' flat gray cards (flat_card), so
    the samples are the ones cv2 would give from the PNGs."""
    from dodt_tpu_torch.data.tracking import KittiTrackingDataset

    class CardImages(base or KittiTrackingDataset):
        def _camera_image(self, video_id, frame):
            return flat_card(scenes[video_id].image_at(frame),
                             self.cfg.image_shape)
    return CardImages(cfg.dataset, split="val")


def eval_cfg(cfg, root):
    """An evaluation config over the fixture at root: every video is a
    val video, and random weights' scores (about 0.5) start and keep
    tracks, so the MOT scorer sees the boxes."""
    cfg.dataset.dataset_dir = root
    cfg.dataset.video_train_ids = ()
    cfg.eval.track_lth = cfg.eval.track_hth = 0.0
    cfg.eval.track_tmin = 1
    return cfg


def numbers(tree, path="results"):
    """Every (path, number) leaf of a results tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numbers(v, f"{path}/{k}")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def check_eval_outputs(results, out_dir, ds, keys):
    """results_{step}.json holds every key the JAX evaluator writes
    (``keys``), a MOT entry per video and 'overall', and only finite
    numbers, but for MOTP where there is no true positive: the official
    protocol sets it to infinity then (tracking/mot_eval.py); there is a
    prediction file for every frame of every video (the MoI frames
    between keyframes included) and a couple file for every couple.
    Returns (frame files, couple files)."""
    step = results["step"]
    with open(os.path.join(out_dir, f"results_{step}.json")) as f:
        disk = json.load(f)
    check(set(disk) == keys, f"results keys {sorted(disk)}")
    vids = sorted({cp.video_id for cp in ds.couples})
    check(set(disk["mot"]) == {str(v) for v in vids} | {"overall"},
          f"MOT entries {sorted(disk['mot'])}")
    def no_tp_motp(path, v):
        parts = path.split("/")
        return (parts[1] == "mot" and parts[-1] == "MOTP" and v == np.inf
                and disk["mot"][parts[2]]["TP"] == 0)
    bad = [(p, v) for p, v in numbers(disk)
           if not np.isfinite(v) and not no_tp_motp(p, v)]
    check(not bad, f"results numbers not finite: {bad}")
    pred = os.path.join(out_dir, f"predictions_{step}")
    frames = sorted(os.listdir(os.path.join(pred, "data")))
    want = sorted({f"{cp.video_id:02d}{f:04d}.txt" for cp in ds.couples
                   for f in range(cp.frame_a, cp.frame_b + 1)})
    check(frames == want, f"frame files {frames} against {want}")
    couples = sorted(os.listdir(os.path.join(pred, "couples")))
    check(couples == sorted(f"{cp.name}.txt" for cp in ds.couples),
          f"couple files {couples}")
    return frames, couples


def full_width_eval(dev, counters, ckpt):
    """run_checkpoint_once on phase 7's checkpoint at full width
    (cars_dt_tracking(data_stride=3), 65536 points) through
    Evaluator(...) with its default device, over write_eval_fixture's two
    videos of EVAL_FRAMES frames (4 val couples each), val_health on.

    Two runs: the first, cold, also scores AP on the Python route beside
    the native one on the same detections; the second is timed. In each,
    the kernels' counters are zeroed just before: B1, B2 and B3 grow by
    their per-pair-forward counts (6, 1, 1) times the forwards, B4 stays
    0, and val_health's train-mode forwards add one B3 launch each and
    nothing else. Returns the timed run's numbers."""
    import shutil
    import torch
    from dodt_tpu_torch import native
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.eval import kitti_ap
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    from dodt_tpu_torch.ops import correlation
    from dodt_tpu_torch.runtime.evaluator import Evaluator

    work = os.path.join(ROOT, "build", "smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    scenes = write_eval_fixture(os.path.join(work, "kitti"), EVAL_SPEEDS,
                                EVAL_FRAMES)
    cfg = eval_cfg(cars_dt_tracking(data_stride=3),
                   os.path.join(work, "kitti"))
    cfg.dataset.max_points = 65536
    cfg.eval.val_health = True
    ds = eval_dataset(cfg, scenes)
    n = len(ds.couples)
    bsz = max(cfg.eval.batch_size, 1)
    n_fwd = -(-n // bsz)
    ev = Evaluator(cfg, DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS), ds, ckpt,
                   os.path.join(work, "out"))
    check(ev.device.type == "cuda" and
          next(ev.model.parameters()).device.type == "cuda",
          f"the evaluator's default device is {ev.device}")
    check(native.available(), "the native AP library did not build")
    everyone = [*counters, correlation._CF_KERNEL]
    b4 = correlation._CF_KERNEL.symbol
    # B1 (3 convs x 2 towers), B2, B3 per pair forward (PERF.md table)
    per_fwd = dict(zip((c.symbol for c in counters), (6, 1, 1)))
    before_vh = {}
    val_health = ev.val_health

    def counted_val_health(*args, **kw):
        before_vh.update({c.symbol: c.launches for c in everyone})
        return val_health(*args, **kw)
    ev.val_health = counted_val_health

    # AP on both routes on the first run's detections
    ap_pairs = []
    evaluate_ap = kitti_ap.evaluate_ap

    def both_routes(gts, dets, *args, **kw):
        got = evaluate_ap(gts, dets, *args, **kw)
        route = native.route()
        ap_pairs.append((got, evaluate_ap(gts, dets, *args,
                                          use_native=False)))
        native.note_route(route)
        return got

    runs = []
    try:
        for run in ("cold", "timed"):
            kitti_ap.evaluate_ap = both_routes if run == "cold" \
                else evaluate_ap
            for c in everyone:
                c.launches = 0
            ev.stage_seconds.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = ev.run_checkpoint_once()
            wall = time.perf_counter() - t0
            launches = {c.symbol: c.launches for c in everyone}
            fwd = before_vh
            vh = {k: launches[k] - fwd[k] for k in launches}
            log(f"evaluate ({run}): {n} couples in {wall:.3f} s, stages "
                f"{dict(ev.stage_seconds)}, launches in the forwards {fwd}, "
                f"in val_health {vh}, AP route {native.route()}")
            for sym, k in per_fwd.items():
                check(fwd[sym] == k * n_fwd,
                      f"{sym}: {fwd[sym]} launches in {n_fwd} forwards")
            check(fwd[b4] == 0 and launches[b4] == 0,
                  "B4 ran in the evaluation")
            check(vh == {**dict.fromkeys(launches, 0),
                         correlation._KERNEL.symbol: n_fwd},
                  f"val_health launched {vh}")
            check(native.route() == "native",
                  f"AP took the {native.route()} route")
            runs.append((wall, dict(ev.stage_seconds), launches, fwd))
    finally:
        kitti_ap.evaluate_ap = evaluate_ap
    worst = max(abs(a[k] - b[k]) for a, b in ap_pairs for k in a)
    log(f"AP native vs Python route over {len(ap_pairs)} calls: max abs "
        f"difference {worst:.3g} AP points")
    check(worst <= 1e-9, f"the AP routes disagree by {worst}")
    frames, couples = check_eval_outputs(results, os.path.join(work, "out"),
                                         ds, RESULT_KEYS)
    mot = results["mot"]["overall"]
    log(f"evaluate: step {results['step']}, {len(frames)} frame files, "
        f"{len(couples)} couple files, AP_3D {results['ap']['AP_3D']}, "
        f"overall MOTA {mot['MOTA']:.4g} TP {mot['TP']} FP {mot['FP']} FN "
        f"{mot['FN']}, val_health {results['val_health']}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    wall, stages, launches, fwd = runs[-1]
    return {"couples": n, "forwards": n_fwd, "wall_s": wall,
            "cold_wall_s": runs[0][0], "stages": stages,
            "launches": launches, "forward_launches": fwd}


# ---------------------------------------------------------------- phase 10

def eval_cuda_vs_cpu(dev):
    """run_checkpoint_once of the small config over one ego-motion video
    of 7 frames at data_stride 3 (couples (0, 3), (3, 6), (6, 6); MoI and
    recovery), on the card and with device="cpu", from one checkpoint
    (init_params, seed 5).

    Per frame file (MoI frames included), the card's and the CPU's boxes
    are held to phase 6's rule: counts within max(2, 10%) and 80% of the
    boxes matched within 0.1. A box is matched on (x, y, z, l, w, h,
    cos ry, sin ry): the decode flips a heading near 0 by pi, so a
    rounding can put it at +pi in one run and -pi in the other, the same
    box. The towers run in f32 with plain convolutions (B1 takes bf16
    only; phase 6 holds it against the CPU): with bf16 towers the random
    weights' near-tied scores reorder under the card's and the CPU's
    rounding (on an NVIDIA H100 only 8 of a frame's 11 final boxes
    matched). AP and MOT are step functions of box overlap and score
    order: a box moved by rounding can cross an IoU gate. So they must
    be equal (1e-6) when every frame's boxes are all matched within 2e-3
    (the files print 3 decimals) with equal counts, and are printed side
    by side otherwise."""
    import copy
    import shutil
    import torch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    from dodt_tpu_torch.runtime.evaluator import Evaluator
    from dodt_tpu_torch.runtime.trainer import (CheckpointIO,
                                                create_train_state)

    work = os.path.join(ROOT, "build", "smoke_eval_small")
    shutil.rmtree(work, ignore_errors=True)
    scenes = write_eval_fixture(os.path.join(work, "kitti"), (0.5,), 7)
    cfg = small_plain_cfg(eval_cfg(small_cfg(), os.path.join(work, "kitti")))
    cfg.dataset.data_stride = 3
    clusters = ((3.9, 1.6, 1.52),)
    model = DtAvodNet(cfg, clusters)
    init_params(model, torch.Generator().manual_seed(5))
    ckpt = os.path.join(work, "ckpt")
    CheckpointIO(ckpt).save(1, create_train_state(cfg, model))
    res, files = {}, {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        ev = Evaluator(cfg, copy.deepcopy(model), eval_dataset(cfg, scenes),
                       ckpt, os.path.join(work, name), device=d)
        res[name] = ev.run_checkpoint_once()
        check(next(ev.model.parameters()).device.type == torch.device(
            d).type, f"{name} evaluator ran on {ev.device}")
        keys = RESULT_KEYS - {"val_health"}
        frame_files, _ = check_eval_outputs(res[name],
                                            os.path.join(work, name),
                                            ev.dataset, keys)
        files[name] = {fn: read_boxes(os.path.join(
            work, name, "predictions_1", "data", fn)) for fn in frame_files}
    exact = compare_eval_runs(files, res)
    shutil.rmtree(work, ignore_errors=True)
    return exact


def read_boxes(path):
    """(n, 7) h w l x y z ry of a KITTI prediction file."""
    with open(path) as f:
        return np.array([[float(v) for v in ln.split()[8:15]]
                         for ln in f.read().splitlines()]).reshape(-1, 7)


def compare_eval_runs(files, res):
    """Phase 10's rule over the card's and the CPU's prediction files
    ({"cuda"|"cpu": {file name: read_boxes}}) and results: per file,
    counts within max(2, 10%) and 80% of the boxes matched within 0.1;
    AP (and MOT) equal to 1e-6 when every box is matched within 2e-3
    with equal counts. Returns whether they all were."""
    import torch
    check(files["cuda"].keys() == files["cpu"].keys(), "frame files differ")

    def boxes(rows):
        # (x, y, z, l, w, h, cos ry, sin ry) of the files' h w l x y z ry
        b = torch.as_tensor(rows)
        return torch.cat([b[:, [3, 4, 5, 2, 1, 0]], torch.cos(b[:, 6:]),
                          torch.sin(b[:, 6:])], 1)

    exact, worst = True, (0.0, None)
    for fn, want in files["cpu"].items():
        got = files["cuda"][fn]
        valid_g, valid_w = (torch.ones(len(x), dtype=torch.bool)
                            for x in (got, want))
        g, w = boxes(got), boxes(want)
        frac = matched_fraction(g, w, valid_g, valid_w, 0.1)
        log(f"evaluate card vs CPU {fn}: boxes cuda {len(got)} cpu "
            f"{len(want)}, matched within 0.1 {frac:.3f}")
        if len(got) and len(want):
            d = (g[:, None] - w[None]).abs().amax(-1)
            if float(d.amin(1).max()) >= worst[0]:
                worst = (float(d.amin(1).max()), fn)
            if frac < 1.0:
                log("  unmatched card rows (h w l x y z ry), nearest CPU "
                    "row: " + "; ".join(
                        f"{got[i].tolist()} {want[int(d[i].argmin())]}"
                        for i in range(len(got)) if d[i].min() > 0.1))
        check(abs(len(got) - len(want)) <= max(2, len(want) // 10),
              f"{fn}: box counts differ, cuda {len(got)} cpu {len(want)}")
        check(frac >= 0.8, f"{fn}: card vs CPU boxes matched {frac}")
        exact &= len(got) == len(want) and min(
            matched_fraction(g, w, valid_g, valid_w, 2e-3),
            matched_fraction(w, g, valid_w, valid_g, 2e-3)) == 1.0
    cpu_numbers = dict(numbers(res["cpu"]))
    pairs = [(p, v, cpu_numbers[p]) for p, v in numbers(res["cuda"])]
    differ = [(p, a, b) for p, a, b in pairs if abs(a - b) > 1e-6]
    log(f"evaluate card vs CPU: largest distance of a card box to its "
        f"nearest CPU box {worst[0]:.4g} ({worst[1]}); every box matched "
        f"within 2e-3: {exact}; "
        f"{len(pairs)} AP and MOT numbers, differing: {differ}")
    if exact:
        check(not differ, f"AP/MOT differ on matched detections: {differ}")
    return exact


# ---------------------------------------------------------------- phase 11

DETECTION_SAMPLES = 8          # the object fixture's samples (one scene)
STAGE_STEPS = (3, 2, 1)        # single-frame pretrain, staged, finetune
STACK_TRAIN_STEPS = 2
FRAME_KEYS = ("points", "points_valid", "image", "gt_boxes", "gt_classes",
              "gt_valid", "gt_track_ids")


def one_frame(batch):
    """Frame 0 of a couple batch as a single-frame sample in the keys
    KittiDataset gives (no correlation targets: zeros)."""
    out = {k: v[:, :1] for k, v in batch.items() if k in FRAME_KEYS}
    out.update({k: batch[k] for k in ("ground_plane", "p2",
                                      "orig_image_shape")})
    if "corr_offsets" in batch:
        out["corr_offsets"] = np.zeros_like(batch["corr_offsets"])
        out["corr_coexist"] = np.zeros_like(batch["corr_coexist"])
    return out


class FrameStream(SmokeStream):
    """SmokeStream's couples, frame 0 only: an in-memory single-frame
    dataset for the Trainer."""

    def next_batch(self, batch_size, augment=True):
        return one_frame(super().next_batch(batch_size, augment))


def write_detection_eval_fixture(root, n_samples):
    """The port's write_detection_fixture for one scene of n_samples
    frames (4 cars, seed 0), without the PNGs. Returns the scene, whose
    images detection_dataset serves."""
    from dodt_tpu_torch.data import synthetic
    synthetic.write_detection_fixture(root, n_samples, images=False)
    return synthetic.SyntheticScene(0, n_samples, seed=0, ego_speed=0.0)


def detection_dataset(cfg, scene):
    """The port's KittiDataset (val split) over
    write_detection_eval_fixture's files, its camera images the scene's
    flat gray cards (flat_card)."""
    from dodt_tpu_torch.data.detection import KittiDataset

    class CardImages(KittiDataset):
        def _camera_image(self, name):
            return flat_card(scene.image_at(int(name)), self.cfg.image_shape)
    return CardImages(cfg.dataset, split="val")


def timed_forward(model, batch, counters, check_out):
    """The val-mode forward of one host batch on the card: the kernels'
    launches in its first call (counters zeroed just before), then the
    median of N_TIMED calls after N_WARM, each synced."""
    import torch
    dev = next(model.parameters()).device
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    for c in counters:
        c.launches = 0
    out = model(tb)
    torch.cuda.synchronize()
    launches = {c.symbol: c.launches for c in counters}
    check_out(out)
    for _ in range(N_WARM):
        model(tb)
    times = []
    for _ in range(N_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(tb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check_out(out)
    return float(np.median(times)), launches, out


def check_finals(out, shapes):
    import torch
    for key, shape in shapes.items():
        v = out[key]
        check(tuple(v.shape) == shape, f"{key} shape {tuple(v.shape)}")
        if v.dtype != torch.bool:
            check(bool(torch.isfinite(v).all()), f"{key} not finite")


def train_run(cfg, model, stream, ckpt, steps, counters):
    """Trainer.train to ``steps`` (from the step its state starts at) on
    the card, the kernels' counters zeroed just before: (state, history,
    step ms after the first, launches)."""
    import torch
    from dodt_tpu_torch.runtime.trainer import Trainer
    cfg.train.checkpoint_interval = 10 ** 6       # only the last step
    trainer = Trainer(cfg, model, stream, ckpt, metrics_path=None)
    for c in counters:
        c.launches = 0
    state, history = trainer.train(max_steps=steps, log_every=1)
    torch.cuda.synchronize()
    launches = {c.symbol: c.launches for c in counters}
    check(state.step == steps and trainer.ckpt.all_steps()[-1] == steps,
          f"{ckpt}: the trainer ended at step {state.step}")
    for h in history:
        bad = [k for k, v in h.items() if not np.isfinite(v)]
        check(not bad, f"{ckpt} step {h['step']}: {bad} not finite")
    log(f"{os.path.basename(ckpt)}: " + "; ".join(
        f"step {h['step']} " + ", ".join(f"{k} {v:.4g}" for k, v in h.items()
                                         if k not in ("step", "wall_s"))
        for h in history))
    steps_ms = np.diff([0.0] + [h["wall_s"] for h in history]) * 1e3
    return state, history, [float(s) for s in steps_ms], launches


def staged_flow(dev, counters):
    """The reference's staged training recipe at full width (65536
    points) through Trainer and Evaluator, each stage's checkpoint the
    next one's source:

    1. cars_single_frame: DtAvodNet(num_frames=1) trains STAGE_STEPS[0]
       steps on FrameStream (init_params, rpn_reg's output layer scaled
       by 1e-2 as in phase 7); its single-frame forward is timed and its
       checkpoint evaluated (detection-only: AP, no MOT) on
       write_detection_eval_fixture's DETECTION_SAMPLES samples, twice
       (cold, timed), B1 and B2 launched in every forward;
    2. cars_dt_tracking_staged: the paired model restores the seven
       DETECTOR_SUBTREES and freezes them; after STAGE_STEPS[1] steps
       every detector tensor equals stage 1's bit for bit, and both
       correlation subtrees moved;
    3. cars_dt_tracking_finetune: the full state continues one step and
       a detector tensor moves.
    Returns the numbers printed at the end."""
    import shutil
    import torch
    from dodt_tpu_torch import config as C
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    from dodt_tpu_torch.runtime.evaluator import Evaluator
    from dodt_tpu_torch.runtime.trainer import CheckpointIO, top_level

    work = os.path.join(ROOT, "build", "smoke_staged")
    shutil.rmtree(work, ignore_errors=True)
    pre_dir, staged_dir, ft_dir = (os.path.join(work, s) for s in (
        "pretrain", "staged", "finetune"))
    clusters = DEFAULT_CAR_CLUSTERS
    detector = set(C.DETECTOR_SUBTREES)

    # ---- stage 1: the single-frame detector
    cfg1 = C.cars_single_frame()
    cfg1.dataset.max_points = 65536
    model1 = DtAvodNet(cfg1, clusters, num_frames=1)
    init_params(model1, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model1.rpn_reg.out.weight.mul_(1e-2)
    check({top_level(k) for k in model1.state_dict()} == detector,
          "the one-frame model's parameters are not the detector's")
    state1, hist1, steps1, train1 = train_run(
        cfg1, model1, FrameStream(cfg1, 11), pre_dir, STAGE_STEPS[0],
        counters)
    check(all(h["corr"] == 0.0 for h in hist1),
          "the single-frame model has a correlation loss")
    model1.load_state_dict(state1.params)
    model1.eval()
    k_final = cfg1.model.avod.nms_size

    def check_one_frame(out):
        check_finals(out, {"final_boxes_3d": (1, 1, k_final, 7),
                           "final_scores": (1, 1, k_final)})
        check("corr_pred" not in out, "the one-frame forward correlated")
    fwd_ms, fwd_launches, _ = timed_forward(
        model1, one_frame(train_batch(cfg1, np.random.RandomState(12))),
        counters, check_one_frame)
    log(f"single-frame forward: {fwd_ms:.3f} ms (median of {N_TIMED}), "
        f"launches {fwd_launches}")
    b1, b2, b3 = (fwd_launches[c.symbol] for c in counters)
    check(b1 > 0 and b2 > 0, "the single-frame eval forward did not launch "
          "B1 and B2")
    check(b3 == 0, "the single-frame forward launched B3")

    scene = write_detection_eval_fixture(os.path.join(work, "kitti_object"),
                                         DETECTION_SAMPLES)
    cfg_e = C.cars_single_frame()
    cfg_e.dataset.max_points = 65536
    cfg_e.dataset.dataset_dir = os.path.join(work, "kitti_object")
    ds = detection_dataset(cfg_e, scene)
    ev = Evaluator(cfg_e, DtAvodNet(cfg_e, clusters, num_frames=1), ds,
                   pre_dir, os.path.join(work, "eval_object"))
    n_fwd = -(-len(ds) // max(cfg_e.eval.batch_size, 1))
    runs = []
    for run in ("cold", "timed"):
        for c in counters:
            c.launches = 0
        ev.stage_seconds.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = ev.run_checkpoint_once()
        wall = time.perf_counter() - t0
        launches = {c.symbol: c.launches for c in counters}
        log(f"detection eval ({run}): {len(ds)} samples in {wall:.3f} s, "
            f"stages {dict(ev.stage_seconds)}, launches {launches}")
        for sym, k in fwd_launches.items():
            check(launches[sym] == k * n_fwd,
                  f"{sym}: {launches[sym]} launches in {n_fwd} forwards")
        runs.append((wall, dict(ev.stage_seconds), launches))
    check(set(results) == {"step", "ap", "ap_per_class", "ap_05_per_class"},
          f"detection results keys {sorted(results)}")
    bad = [(p, v) for p, v in numbers(results) if not np.isfinite(v)]
    check(not bad, f"detection results not finite: {bad}")
    files = sorted(os.listdir(os.path.join(work, "eval_object",
                                           f"predictions_{STAGE_STEPS[0]}",
                                           "data")))
    check(files == [f"{n}.txt" for n in ds.sample_names],
          f"detection prediction files {files}")
    log(f"detection eval: AP_3D {results['ap']['AP_3D']}")

    # ---- stage 2: the paired model, detector restored and frozen
    cfg2 = C.cars_dt_tracking_staged(pre_dir)
    cfg2.dataset.max_points = 65536
    model2 = DtAvodNet(cfg2, clusters)
    init_params(model2, torch.Generator().manual_seed(1))
    corr0 = {k: v.clone() for k, v in model2.state_dict().items()
             if top_level(k) not in detector}
    state2, _, steps2, train2 = train_run(
        cfg2, model2, SmokeStream(cfg2, 7), staged_dir, STAGE_STEPS[1],
        counters)
    pre = CheckpointIO(pre_dir).restore_params()
    same = [k for k in pre if torch.equal(state2.params[k].cpu(), pre[k])]
    check(len(same) == len(pre) == sum(top_level(k) in detector
                                       for k in state2.params),
          f"frozen detector tensors changed: {sorted(set(pre) - set(same))}")
    moved = {}
    for k, v in corr0.items():
        d = float((state2.params[k].cpu() - v).abs().max())
        moved[top_level(k)] = max(moved.get(top_level(k), 0.0), d)
    log(f"staged: {len(same)} detector tensors bit-equal to the pretrain, "
        f"correlation branch moved by {moved}")
    check(set(moved) == {"bev_corr_bottleneck", "corr_fc"}
          and all(v > 0 for v in moved.values()),
          f"the correlation branch did not train: {moved}")

    # ---- stage 3: joint finetune from the staged full state
    cfg3 = C.cars_dt_tracking_finetune(staged_dir)
    cfg3.dataset.max_points = 65536
    state3, _, steps3, _ = train_run(
        cfg3, DtAvodNet(cfg3, clusters), SmokeStream(cfg3, 8), ft_dir,
        STAGE_STEPS[1] + STAGE_STEPS[2], counters)
    det_moved = max(float((state3.params[k] - state2.params[k]).abs().max())
                    for k in pre)
    log(f"finetune: step {state3.step}, detector moved by {det_moved:.4g}")
    check(det_moved > 0, "the finetune did not move the detector")
    shutil.rmtree(work, ignore_errors=True)
    wall, stages, launches = runs[-1]
    return {"forward_ms": fwd_ms, "forward_launches": fwd_launches,
            "samples": len(ds), "eval_wall_s": wall,
            "eval_cold_wall_s": runs[0][0], "eval_stages": stages,
            "eval_launches": launches,
            "step_ms": {"pretrain": steps1, "staged": steps2,
                        "finetune": steps3},
            "train_launches": {"pretrain": train1, "staged": train2}}


# ---------------------------------------------------------------- phase 12

STACK_FRAMES = 4               # cars_dt_tracking(data_stride=3)


def stack_batch(batch, frames=STACK_FRAMES):
    """A couple batch (train_batch's or make_batch's) as an N-frame stack
    in the keys KittiTrackingStackDataset gives: the couple's frames in
    turn, GT per frame, frame 0's GT as the merged (hull) boxes, every
    track in both keyframes with the couple's corr_offsets as motion."""
    idx = [i % 2 for i in range(frames)]
    out = {k: v[:, idx] for k, v in batch.items() if k in FRAME_KEYS}
    out.update({k: batch[k] for k in ("ground_plane", "p2",
                                      "orig_image_shape")})
    if "gt_boxes" in batch:
        out.update({"merged_boxes": batch["gt_boxes"][:, 0],
                    "merged_classes": batch["gt_classes"][:, 0],
                    "merged_valid": batch["gt_valid"][:, 0],
                    "coexist": np.zeros(batch["gt_valid"][:, 0].shape,
                                        np.float32),
                    "corr_offsets": batch["corr_offsets"]})
    return out


class StackStream(SmokeStream):
    """SmokeStream's couples as STACK_FRAMES-frame stacks."""

    def next_batch(self, batch_size, augment=True):
        return stack_batch(super().next_batch(batch_size, augment))


def stack_full_width(dev, counters):
    """The Stack model at full width: cars_dt_tracking(data_stride=3)
    with model_name stack_avod_model (4 frames), 65536 points, random
    weights (init_params, rpn_reg's output layer scaled by 1e-2). Its
    val-mode forward (B1 and B2 must launch), STACK_TRAIN_STEPS Trainer
    steps on StackStream (compute_stack_losses through loss_builder;
    B1 and B2 must not launch), and one run_checkpoint_once of that
    checkpoint over phase 9's tracking fixture read through
    KittiTrackingStackDataset, val_health on: every result key and
    finite number, every frame and couple file, B1 and B2 launched per
    forward as in the timed one."""
    import shutil
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.data.stack import KittiTrackingStackDataset
    from dodt_tpu_torch.models.dt_avod import init_params
    from dodt_tpu_torch.models.stack import StackAvodNet
    from dodt_tpu_torch.runtime.evaluator import Evaluator

    def stack_cfg():
        cfg = cars_dt_tracking(data_stride=STACK_FRAMES - 1)
        cfg.model.model_name = "stack_avod_model"
        cfg.dataset.max_points = 65536
        return cfg

    work = os.path.join(ROOT, "build", "smoke_stack")
    shutil.rmtree(work, ignore_errors=True)
    cfg = stack_cfg()
    model = StackAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.rpn_reg.out.weight.mul_(1e-2)
    model.to(dev).eval()
    k, k_final = cfg.model.rpn.test_nms_size, cfg.model.avod.nms_size
    fwd_ms, fwd_launches, out = timed_forward(
        model, stack_batch(train_batch(cfg, np.random.RandomState(13))),
        counters, lambda out: check_finals(out, {
            "top_anchors": (1, k, 6),
            "final_boxes_3d": (1, STACK_FRAMES, k_final, 7),
            "final_scores": (1, STACK_FRAMES, k_final),
            "final_coexist": (1, k_final),
            "final_corr_offsets": (1, k_final, 3)}))
    log(f"Stack forward: {fwd_ms:.3f} ms (median of {N_TIMED}), "
        f"{out['anchors'].shape[1]} anchors, valid finals per frame "
        f"{out['final_valid'].sum(-1).tolist()}, launches {fwd_launches}")
    b1, b2, b3 = (fwd_launches[c.symbol] for c in counters)
    check(b1 > 0 and b2 > 0, "the Stack eval forward did not launch B1 "
          "and B2")
    check(b3 == 0, "the Stack forward launched B3")

    model.train()
    torch.cuda.reset_peak_memory_stats(dev)
    ckpt = os.path.join(work, "ckpt")
    state, history, steps_ms, train_launches = train_run(
        cfg, model, StackStream(cfg, 14), ckpt, STACK_TRAIN_STEPS, counters)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    check("coexist" in history[-1], "the Trainer did not take the Stack "
          "losses")
    check(all(v == 0 for v in train_launches.values()),
          f"a kernel ran in Stack training: {train_launches}")
    log(f"Stack training: step ms {steps_ms}, peak device memory "
        f"{peak:.0f} MiB")

    scenes = write_eval_fixture(os.path.join(work, "kitti"), EVAL_SPEEDS,
                                EVAL_FRAMES)
    cfg_e = eval_cfg(stack_cfg(), os.path.join(work, "kitti"))
    cfg_e.eval.val_health = True
    ds = eval_dataset(cfg_e, scenes, KittiTrackingStackDataset)
    ev = Evaluator(cfg_e, StackAvodNet(cfg_e, DEFAULT_CAR_CLUSTERS), ds,
                   ckpt, os.path.join(work, "out"))
    n = len(ds.couples)
    n_fwd = -(-n // max(cfg_e.eval.batch_size, 1))
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    results = ev.run_checkpoint_once()
    wall = time.perf_counter() - t0
    launches = {c.symbol: c.launches for c in counters}
    check_eval_outputs(results, os.path.join(work, "out"), ds, RESULT_KEYS)
    for sym, per in fwd_launches.items():
        check(launches[sym] == per * n_fwd,
              f"{sym}: {launches[sym]} launches in {n_fwd} Stack forwards")
    mot = results["mot"]["overall"]
    log(f"Stack evaluate: {n} stacks in {wall:.3f} s, stages "
        f"{dict(ev.stage_seconds)}, launches {launches}, AP_3D "
        f"{results['ap']['AP_3D']}, overall MOTA {mot['MOTA']:.4g}, "
        f"val_health {results['val_health']}")
    shutil.rmtree(work, ignore_errors=True)
    return {"forward_ms": fwd_ms, "forward_launches": fwd_launches,
            "step_ms": steps_ms, "peak_mib": peak, "stacks": n,
            "eval_wall_s": wall, "eval_launches": launches}


# ---------------------------------------------------------------- phase 13

def small_plain_cfg(cfg=None):
    """small_cfg (or cfg) in f32 with plain convolutions (B1 takes bf16
    only; phase 6 holds it against the CPU)."""
    cfg = cfg or small_cfg()
    cfg.model.tower_dtype = "float32"
    for ext in (cfg.model.bev_extractor, cfg.model.img_extractor):
        ext.fused_interior = ()
    return cfg


def hold_finals(og, oc, what):
    """Phase 6's rule per frame row of (B, F, K, ...) final outputs:
    counts within max(2, 10%), 80% of the boxes matched within 0.1."""
    for b in range(og["final_valid"].shape[0]):
        for f in range(og["final_valid"].shape[1]):
            vg = og["final_valid"][b, f].cpu()
            vc = oc["final_valid"][b, f]
            fin = matched_fraction(og["final_boxes_3d"][b, f],
                                   oc["final_boxes_3d"][b, f], vg, vc, 0.1)
            log(f"{what} sample {b} frame {f}: valid finals cuda "
                f"{int(vg.sum())} cpu {int(vc.sum())}, final boxes matched "
                f"{fin:.3f}")
            check(abs(int(vg.sum()) - int(vc.sum())) <= max(2, vc.sum() // 10),
                  f"{what} {b}/{f}: valid final counts differ")
            check(fin >= 0.8, f"{what} {b}/{f}: final boxes matched {fin}")


def new_families_cuda_vs_cpu(dev):
    """The one-frame and the Stack forward of the small config (f32,
    plain convolutions) on the card against the CPU with the same
    weights, held to phase 6's rule; then the detection-only evaluation
    of the one-frame model (write_detection_eval_fixture, 4 samples) on
    the card and on the CPU from one checkpoint, held to phase 10's
    rule. Returns whether every box matched within 2e-3."""
    import copy
    import shutil
    import torch
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    from dodt_tpu_torch.models.stack import StackAvodNet
    from dodt_tpu_torch.runtime.evaluator import Evaluator
    from dodt_tpu_torch.runtime.trainer import (CheckpointIO,
                                                create_train_state)

    clusters = ((3.9, 1.6, 1.52),)
    couples = [make_batch(small_cfg(), np.random.RandomState(s))
               for s in (1, 2)]
    for what, model_cls, kw, make in (
            ("one-frame forward", DtAvodNet, {"num_frames": 1}, one_frame),
            ("Stack forward", StackAvodNet, {}, stack_batch)):
        cfg = small_plain_cfg()
        cfg.dataset.data_stride = STACK_FRAMES - 1
        cpu_model = model_cls(cfg, clusters, **kw)
        init_params(cpu_model, torch.Generator().manual_seed(1))
        cpu_model.eval()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        parts = [make(c) for c in couples]
        host = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        og = gpu_model({k: torch.as_tensor(v, device=dev)
                        for k, v in host.items()})
        oc = cpu_model({k: torch.as_tensor(v) for k, v in host.items()})
        check(set(og) == set(oc), f"{what}: keys differ")
        check(torch.equal(og["anchor_valid"].cpu(), oc["anchor_valid"]),
              f"{what}: anchor_valid differs")
        hold_finals(og, oc, what)

    work = os.path.join(ROOT, "build", "smoke_eval_object")
    shutil.rmtree(work, ignore_errors=True)
    scene = write_detection_eval_fixture(os.path.join(work, "kitti"), 4)
    cfg = small_plain_cfg()
    cfg.model.model_name = "avod_model"
    cfg.dataset.dataset_dir = os.path.join(work, "kitti")
    model = DtAvodNet(cfg, clusters, num_frames=1)
    init_params(model, torch.Generator().manual_seed(5))
    ckpt = os.path.join(work, "ckpt")
    CheckpointIO(ckpt).save(1, create_train_state(cfg, model))
    res, files = {}, {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        ev = Evaluator(cfg, copy.deepcopy(model), detection_dataset(
            cfg, scene), ckpt, os.path.join(work, name), device=d)
        res[name] = ev.run_checkpoint_once()
        data = os.path.join(work, name, "predictions_1", "data")
        files[name] = {fn: read_boxes(os.path.join(data, fn))
                       for fn in sorted(os.listdir(data))}
        check(sorted(files[name]) == [f"{n}.txt" for n in
                                      ev.dataset.sample_names],
              f"{name} detection files {sorted(files[name])}")
    exact = compare_eval_runs(files, res)
    shutil.rmtree(work, ignore_errors=True)
    return exact


# ---------------------------------------------------------------- phase 14

VARIANT_TRAIN_STEPS = 1
PEOPLE = ("Pedestrian", "Cyclist")


def variant_configs(base):
    """{name: (config, clusters)} of the three variant configs on
    ``base()`` (a config maker): V1 box_8c, late fusion by max, plain
    VGG towers, fast NMS; V2 box_3d, deep fusion by mean, GroupNorm
    towers, greedy NMS; V3 the people preset's head (two classes, a size
    cluster each, its mini-batch ranges) with box_8co and early fusion by
    concat (the RPN's too)."""
    from dodt_tpu_torch.config import people_dt_tracking
    from dodt_tpu_torch.data.clusters import (DEFAULT_CAR_CLUSTERS,
                                              size_priors)

    def variant(rep, method, ftype, nms, tower=None, people=False):
        cfg = base()
        cfg.model.avod.box_representation = rep
        cfg.model.avod.fusion_method = method
        cfg.model.avod.fusion_type = ftype
        cfg.model.nms_mode = nms
        for ext in (cfg.model.bev_extractor, cfg.model.img_extractor):
            if tower == "plain":
                ext.pyramid = False
            elif tower == "gn":
                ext.norm = "gn"
        clusters = DEFAULT_CAR_CLUSTERS
        if people:
            p = people_dt_tracking()
            cfg.dataset.classes = p.dataset.classes
            cfg.dataset.num_clusters = p.dataset.num_clusters
            for k in ("rpn_neg_iou_range", "rpn_pos_iou_range",
                      "avod_neg_iou_range", "avod_pos_iou_range"):
                setattr(cfg.dataset.mini_batch, k,
                        getattr(p.dataset.mini_batch, k))
            cfg.model.rpn.fusion_method = "concat"
            clusters = tuple(tuple(float(v) for v in size_priors(c, 1)[0])
                             for c in PEOPLE)
        return cfg, clusters

    return {"V1": variant("box_8c", "max", "late", "fast", "plain"),
            "V2": variant("box_3d", "mean", "deep", "greedy", "gn"),
            "V3": variant("box_8co", "concat", "early", "exact",
                          people=True)}


def variants_full_width(dev, counters):
    """V1-V3 (variant_configs) on cars_dt_tracking at 65536 points with
    seeded random weights: the val pair forward on make_batch's couple
    (median of N_TIMED synced calls after N_WARM, the kernels' launches
    in its first call) and VARIANT_TRAIN_STEPS Trainer steps on phase 7's
    stream (finite losses, step ms, peak memory). B1 must launch on V1
    and V3 and not on V2 (GroupNorm towers take plain convolutions, as
    in JAX); B2 and B3 on all three. V2's forward is timed once more
    with exact NMS, which gives greedy NMS's share of it."""
    import shutil
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params

    def base():
        cfg = cars_dt_tracking()
        cfg.dataset.max_points = 65536
        return cfg

    work = os.path.join(ROOT, "build", "smoke_variants")
    shutil.rmtree(work, ignore_errors=True)
    res = {}
    for name, (cfg, clusters) in variant_configs(base).items():
        model = DtAvodNet(cfg, clusters)
        init_params(model, torch.Generator().manual_seed(0))
        model.to(dev).eval()
        k_final = cfg.model.avod.nms_size
        n_cls = len(cfg.dataset.classes) + 1
        batch = make_batch(cfg, np.random.RandomState(0))
        fwd_ms, launches, out = timed_forward(
            model, batch, counters, lambda out: check_finals(out, {
                "final_boxes_3d": (1, 2, k_final, 7),
                "final_scores": (1, 2, k_final),
                "final_cls_softmax": (1, 2, k_final, n_cls),
                "final_corr_offsets": (1, k_final, 3)}))
        b1, b2, b3 = (launches[c.symbol] for c in counters)
        log(f"variant {name} forward: {fwd_ms:.3f} ms (median of "
            f"{N_TIMED}), valid finals per frame "
            f"{out['final_valid'].sum(-1).tolist()}, launches {launches}")
        check((b1 > 0) == (name != "V2"),
              f"{name}: B1 launched {b1} times in the forward")
        check(b2 > 0 and b3 > 0, f"{name}: B2/B3 not launched ({b2}, {b3})")
        res[name] = {"forward_ms": fwd_ms, "launches": launches}
        if name == "V2":
            model.cfg.model.nms_mode = "exact"
            res[name]["exact_nms_forward_ms"] = timed_forward(
                model, batch, counters, lambda out: None)[0]
            model.cfg.model.nms_mode = "greedy"
            log(f"variant V2 forward with exact NMS: "
                f"{res[name]['exact_nms_forward_ms']:.3f} ms")
        del out
        model.train()
        torch.cuda.reset_peak_memory_stats(dev)
        _, history, steps_ms, _ = train_run(
            cfg, model, SmokeStream(cfg, 7), os.path.join(work, name),
            VARIANT_TRAIN_STEPS, counters)
        res[name].update(step_ms=steps_ms, peak_mib=torch.cuda.
                         max_memory_allocated(dev) / 2 ** 20,
                         loss=history[-1]["total"])
        log(f"variant {name} training: step ms {steps_ms}, peak device "
            f"memory {res[name]['peak_mib']:.0f} MiB")
        del model
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return res


# ---------------------------------------------------------------- phase 15

def variants_cuda_vs_cpu(dev):
    """V1-V3 at unittest widths (small_plain_cfg: f32, plain
    convolutions) at B = 2 on the card against the CPU with the same
    weights, held to phase 6's rule."""
    import copy
    import torch
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params

    for name, (cfg, clusters) in variant_configs(small_plain_cfg).items():
        cpu_model = DtAvodNet(cfg, clusters)
        init_params(cpu_model, torch.Generator().manual_seed(1))
        cpu_model.eval()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        parts = [make_batch(cfg, np.random.RandomState(s)) for s in (1, 2)]
        host = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        og = gpu_model({k: torch.as_tensor(v, device=dev)
                        for k, v in host.items()})
        oc = cpu_model({k: torch.as_tensor(v) for k, v in host.items()})
        check(set(og) == set(oc), f"{name}: keys differ")
        check(torch.equal(og["anchor_valid"].cpu(), oc["anchor_valid"]),
              f"{name}: anchor_valid differs")
        hold_finals(og, oc, f"variant {name} forward")


# ---------------------------------------------------------------- phase 16

def run_cli(*argv):
    """cli.main(argv) with its standard output captured and returned."""
    import contextlib
    import io
    from dodt_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    return buf.getvalue()


def same_tracks(a, b):
    """Two runs' KITTI tracking lines per video hold the same rows (frame,
    track id, type) with every number within one unit of the lines' 4th
    decimal: the couple files keep 6 decimals of each box, so a 4-decimal
    field may round the other way."""
    if a.keys() != b.keys():
        return False
    for vid in a:
        if len(a[vid]) != len(b[vid]):
            return False
        for la, lb in zip(a[vid], b[vid]):
            pa, pb = la.split(), lb.split()
            if pa[:3] != pb[:3] or len(pa) != len(pb) or max(
                    abs(float(x) - float(y))
                    for x, y in zip(pa[3:], pb[3:])) > 1.5e-4:
                return False
    return True


def cli_full_width(dev, counters):
    """The port's CLI at full width (``python -m dodt_tpu_torch.cli``'s
    main): a JSON config of cars_dt_tracking(data_stride=3) at 65536
    points over write_eval_fixture's two videos (video 0 trains, video 1
    evaluates), the datasets' camera images the scenes' flat gray cards
    (use_flat_cards, KittiTrackingDataset._camera_image restored after
    the phase). train
    takes 2 steps; evaluate writes results_2.json (every key, finite
    numbers, every frame and couple file) with B1-B3 launched in every
    forward; infer times --max_samples 8; demo runs where matplotlib is
    installed. Then the offline video MOT over evaluate's files: both
    arms over the couple files, the IoU arm's tracks equal to those from
    the evaluator's in-memory keyframe detections, and the IoU arm over
    the per-frame files scored. Returns the numbers phase 16 prints."""
    import copy
    import importlib.util
    import shutil
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.tracking import KittiTrackingDataset
    from dodt_tpu_torch.runtime import video
    from dodt_tpu_torch.runtime.evaluator import Evaluator

    work = os.path.join(ROOT, "build", "smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    scenes = write_eval_fixture(root, EVAL_SPEEDS, EVAL_FRAMES)
    cfg = eval_cfg(cars_dt_tracking(data_stride=3), root)
    cfg.dataset.max_points = 65536
    cfg.dataset.video_train_ids = (0,)
    cfg.train.checkpoint_interval = 2
    cfg_path = os.path.join(work, "cfg.json")
    cfg.save(cfg_path)
    ckpt, out_dir = os.path.join(work, "ckpt"), os.path.join(work, "eval")
    device = ["--device", str(dev)]
    ds = eval_dataset(cfg, scenes)
    n = len(ds.couples)
    in_memory = {}
    run_tracking = Evaluator._run_tracking

    def spy(self, video_dets, video_img_size=None):
        in_memory.update(copy.deepcopy(dict(video_dets)))
        return run_tracking(self, video_dets, video_img_size)

    camera_image = KittiTrackingDataset._camera_image
    use_flat_cards()
    Evaluator._run_tracking = spy
    res = {"couples": n}
    try:
        log(run_cli(*device, "train", "--config", cfg_path, "--ckpt_dir",
                    ckpt, "--max_steps", "2").strip())
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = run_cli(*device, "evaluate", "--config", cfg_path,
                          "--ckpt_dir", ckpt, "--output_dir", out_dir)
        torch.cuda.synchronize()
        res["eval_s"] = time.perf_counter() - t0
        res["launches"] = {c.symbol: c.launches for c in counters}
        log("cli evaluate table: " + " | ".join(
            printed.strip().splitlines()[-2:]))
        with open(os.path.join(out_dir, "results_2.json")) as f:
            results = json.load(f)
        keys = RESULT_KEYS if cfg.eval.val_health else \
            RESULT_KEYS - {"val_health"}
        check_eval_outputs(results, out_dir, ds, keys)
        for sym, k in zip((c.symbol for c in counters), (6, 1, 1)):
            check(res["launches"][sym] >= k * n,
                  f"cli evaluate: {sym} launched {res['launches'][sym]} "
                  f"times for {n} couples")
        printed = run_cli(*device, "infer", "--config", cfg_path,
                          "--ckpt_dir", ckpt, "--max_samples", "8",
                          "--output_dir", os.path.join(work, "infer"))
        res["infer"] = json.loads(printed.strip().splitlines()[-1])
        check(res["infer"]["fps_pairs"] > 0, f"infer: {res['infer']}")
        res["matplotlib"] = importlib.util.find_spec("matplotlib") \
            is not None
        if res["matplotlib"]:
            run_cli(*device, "demo", "--config", cfg_path, "--output_dir",
                    os.path.join(work, "demo"), "--split", "val")
            for fn in ("bev_sample.png", "anchor_grid.png",
                       "dataset_stats.json"):
                check(os.path.isfile(os.path.join(work, "demo", fn)),
                      f"demo wrote no {fn}")
    finally:
        KittiTrackingDataset._camera_image = camera_image
        Evaluator._run_tracking = run_tracking

    # the offline video MOT over evaluate's files: the couple files
    # (keyframes with their offsets) through both arms, the IoU arm's
    # tracks equal to those from the evaluator's in-memory keyframe
    # detections; the per-frame KITTI files (the only ones with 2D boxes,
    # which score_tracking matches) through the IoU arm
    pred = os.path.join(out_dir, "predictions_2")
    couples = video.load_couple_detections(os.path.join(pred, "couples"))
    keyframes = {vid: {f: in_memory[vid][f] for f in frames}
                 for vid, frames in couples.items()}
    ev = cfg.eval
    kw = dict(sigma_l=ev.track_lth, sigma_h=ev.track_hth,
              sigma_iou=ev.track_liou, t_min=ev.track_tmin)
    stride = cfg.dataset.data_stride
    iou_lines = video.run_video_pipeline(
        couples, tracker="iou", stride=stride,
        align_fn=video.dataset_align_fn(ds), **kw)
    memory_lines = video.run_video_pipeline(
        keyframes, tracker="iou", stride=stride,
        align_fn=video.dataset_align_fn(ds), **kw)
    kf_lines = video.run_video_pipeline(
        couples, tracker="kf", stride=stride,
        ego_fn=video.dataset_ego_fn(ds), **kw)
    frame_lines = video.run_video_pipeline(
        video.load_kitti_detections(os.path.join(pred, "data")),
        tracker="iou", interpolate=False,
        align_fn=video.dataset_align_fn(ds), **kw)
    n_tracks = {name: len({ln.split()[1] for v in lines.values()
                           for ln in v})
                for name, lines in (("iou", iou_lines), ("kf", kf_lines),
                                    ("frames", frame_lines))}
    mot = video.score_tracking(frame_lines, ds.labels)["overall"]
    log(f"offline video MOT: tracks {n_tracks}, lines "
        f"{sum(map(len, iou_lines.values()))} (iou, couple files), "
        f"{sum(map(len, memory_lines.values()))} (iou, in memory); frame "
        f"files' iou arm {mot}")
    check(n_tracks["iou"] > 0 and n_tracks["kf"] > 0,
          f"the offline arms made no tracks: {n_tracks}")
    check(same_tracks(iou_lines, memory_lines), "the offline IoU arm's "
          "tracks differ from those of the evaluator's in-memory "
          "detections")
    res.update(tracks=n_tracks, offline_mota=mot["MOTA"],
               eval_mota=results["mot"]["overall"]["MOTA"])
    shutil.rmtree(work, ignore_errors=True)
    return res


# ---------------------------------------------------------------- phase 17

MESH_STEPS = 3
MESH_DEADLINE_S = 600.0
MESH_CARDS_DEADLINE_S = 300.0
# a state after a step, mesh against one process, leaf by leaf (params,
# EMA, the optimiser's moments): a mesh of several ranks sums in other
# orders than one process (the all-reduces, the TP trunks' column
# blocks), so its difference is held to a fraction of the largest value
# of its kind over the state: 1e-4 for the moments (sums in another
# order: a leaf whose gradient is rounding noise, such as the bottleneck
# convs' biases ahead of a one-group GroupNorm, changes wholly), 1e-6 for
# params and EMA (their own rounding). One process's step is reproducible
# (ROADMAP C19), so no second run widens the bound.
STATE_FLOOR = {"params": 1e-6, "ema_params": 1e-6, "mu": 1e-4, "nu": 1e-4,
               "trace": 1e-4}
# losses a mesh step is also held to the one-process step at the global
# batch by (1e-3): the RPN's, which no proposal feeds (the second stage's
# and the correlation's losses weigh the proposals that match a ground
# truth box, so they follow which proposals win, and a near-tie can fall
# either way between batch sizes: phase 17(b) logs proposal_swaps)
BATCH_FREE_LOSSES = ("rpn_cls", "rpn_reg")


def smoke_model(cfg):
    """Phase 7's random weights: init_params from seed 0 with rpn_reg's
    output layer scaled by 1e-2 (so the second stage sees positives)."""
    import torch
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.rpn_reg.out.weight.mul_(1e-2)
    return model


def mesh_cfg(work=None):
    """cars_dt_tracking at 65536 points; with ``work``, phase 9's
    evaluation fixture under it (val_health off)."""
    from dodt_tpu_torch.config import cars_dt_tracking
    cfg = cars_dt_tracking(data_stride=3 if work else 1)
    if work:
        cfg = eval_cfg(cfg, os.path.join(work, "kitti"))
    cfg.dataset.max_points = 65536
    cfg.train.checkpoint_interval = MESH_STEPS
    return cfg


def f32_steps(cfg):
    """``cfg`` with f32 towers and heads, and phase 7's weights for it:
    the train steps that 17(b) and 19 hold against one process run in
    f32, so a mesh step differs from one process's only by f32 sums in
    another order. (In bf16 the heads' gradient GEMMs of another shape
    round otherwise by about a bf16 ulp: up to 1e-2 of the momentum
    trace's scale on an H100.)"""
    import copy
    scfg = copy.deepcopy(cfg)
    scfg.model.tower_dtype = "float32"
    return scfg, smoke_model(scfg)


def split_step(cfg, model, batch, n, dev):
    """One process's momentum step of the ``n``-couple ``batch`` computed
    couple by couple, as ``n`` data ranks compute it: each couple's
    gradients from its rows of the step-0 draws (the Trainer's
    generator, ``shard_draws``), averaged, then the optimiser's update.
    The card's convolution backward rounds otherwise at another batch
    size, so this, not the n-couple step, is what a mesh step is held
    to. Returns {"state": params and optimiser state on the CPU,
    "losses": [each loss averaged over the couples]}."""
    import torch
    from dodt_tpu_torch.models.dt_avod import generator_draws
    from dodt_tpu_torch.parallel import mesh as mesh_lib
    from dodt_tpu_torch.runtime import trainer as tl
    model = model.to(dev)
    state = tl.create_train_state(cfg, model)
    tx = tl.make_optimizer(cfg)
    loss_fn = tl.model_losses(model)
    mean = {k: torch.zeros_like(v) for k, v in state.params.items()}
    losses = {}
    for i in range(n):
        g = torch.Generator(dev)
        g.manual_seed(tl.SEED << 32)
        rand = mesh_lib.shard_draws(generator_draws(g), mesh_lib.Mesh(
            {"data": n, "model": 1}, i, 0, None, None))
        rows = {k: torch.as_tensor(v[i:i + 1], device=dev)
                for k, v in batch.items() if isinstance(v, np.ndarray)}
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        out = torch.func.functional_call(
            model, params, (rows,),
            {"mode": "train", "train": True, "rand": rand})
        total, parts = loss_fn(cfg, out, rows, rand)
        for k, v in parts.items():
            losses[k] = losses.get(k, 0.0) + float(v.detach()) / n
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        for (k, _), gr in zip(params.items(), grads):
            if gr is not None:
                mean[k] += gr
    for k in mean:
        mean[k] /= n
    updates, opt_state = tx.update(mean, state.opt_state)
    new = {k: p + updates[k] for k, p in state.params.items()}
    cpu = {k: v.detach().cpu() for k, v in new.items()}
    opt = {k: ({j: t.detach().cpu() for j, t in v.items()}
               if isinstance(v, dict) else v) for k, v in opt_state.items()}
    return {"state": {"params": cpu, "opt_state": opt, "ema_params": None},
            "losses": [losses]}


def proposal_swaps(cfg, model, batch, n, dev):
    """The proposals the second stage sees in the ``n``-couple train
    forward against each couple's own forward (split_step's rows and
    draws), per couple: the largest objectness difference, how many of
    the post-NMS proposals (top_anchors, every frame) sit at another
    position, and how many the couple's own forward does not hold at all
    (no box within 1e-3 of it). With random weights many scores are near
    ties, and a last-bit difference (a convolution at another batch size)
    can swap them; the second stage's losses then part."""
    import torch
    from dodt_tpu_torch.models.dt_avod import generator_draws
    from dodt_tpu_torch.parallel import mesh as mesh_lib
    from dodt_tpu_torch.runtime import trainer as tl
    model = model.to(dev)

    def forward(rows, shard=None):
        g = torch.Generator(dev)
        g.manual_seed(tl.SEED << 32)
        rand = generator_draws(g)
        if shard is not None:
            rand = mesh_lib.shard_draws(rand, mesh_lib.Mesh(
                {"data": n, "model": 1}, shard, 0, None, None))
        with torch.no_grad():
            out = model({k: torch.as_tensor(v, device=dev)
                         for k, v in rows.items()
                         if isinstance(v, np.ndarray)},
                        mode="train", train=True, rand=rand)
        return {k: out[k].cpu() for k in ("objectness", "top_anchors",
                                          "top_valid")}

    whole = forward(batch)
    swaps = []
    for i in range(n):
        own = forward({k: v[i:i + 1] for k, v in batch.items()
                       if isinstance(v, np.ndarray)}, i)
        obj = float((whole["objectness"].float().reshape(n, -1)[i]
                     - own["objectness"].float().reshape(-1)).abs().max())
        moved = missing = valid = 0
        for a, va, b, vb in zip(whole["top_anchors"][i].float(),
                                whole["top_valid"][i],
                                own["top_anchors"][0].float(),
                                own["top_valid"][0]):
            near = (a - b).abs().amax(-1) <= 1e-3
            moved += int(((va | vb) & ~(near & (va == vb))).sum())
            a, b = a[va], b[vb]
            valid += len(a)
            if len(a) and len(b):
                dist = (a[:, None] - b[None]).abs().amax(-1)
                missing += int((dist.amin(1) > 1e-3).sum())
            else:
                missing += len(a)
        swaps.append({"objectness": obj, "moved": moved,
                      "missing": missing, "valid": valid})
    return swaps


def eval_scenes():
    """write_eval_fixture's scenes (seeded, so every process rebuilds
    the same ones)."""
    from dodt_tpu_torch.data import synthetic
    return {vid: synthetic.SyntheticScene(vid, EVAL_FRAMES, ego_speed=s)
            for vid, s in enumerate(EVAL_SPEEDS)}


def mesh_evaluate(cfg, work, ckpt, out, idxs, mesh_shape, device):
    """launch.evaluate over phase 9's fixture (eval_dataset's flat gray
    cards), the checkpoint's step MESH_STEPS."""
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    from dodt_tpu_torch.parallel import launch
    return launch.evaluate(cfg, DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS),
                           eval_dataset(cfg, eval_scenes()), ckpt, out, idxs,
                           MESH_STEPS, mesh_shape, device)


def card_rank(programs):
    """One rank of phase 17(b): TF32 off as in the main process, then
    each (name, fn, args) of ``programs`` with the kernels' counters
    zeroed just before it; returns each result with its launches and
    this rank's peak device memory."""
    import torch
    from dodt_tpu_torch.ops import conv_chain, correlation, roi_window
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = [conv_chain._KERNEL, roi_window._KERNEL, correlation._KERNEL]
    card = torch.cuda.is_available()       # False only in a CPU rehearsal
    out = {}
    if card:
        torch.cuda.reset_peak_memory_stats()
    for name, fn, args in programs:
        for c in counters:
            c.launches = 0
        res = fn(*args)
        res["launches"] = {c.symbol: c.launches for c in counters}
        out[name] = res
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20 \
        if card else None
    return out


def state_leaves(tree):
    """(part, name, tensor) of a TrainState dict: params, EMA and the
    optimiser's moments."""
    for part in ("params", "ema_params"):
        for k, v in (tree.get(part) or {}).items():
            yield part, k, v
    for part in ("mu", "nu", "trace"):
        for k, v in tree["opt_state"].get(part, {}).items():
            yield part, k, v


def differing_leaves(got, want):
    """The leaves of two TrainState dicts that are not bit-equal."""
    import torch
    g = {(p, k): v for p, k, v in state_leaves(got)}
    return [f"{p} {k}" for p, k, v in state_leaves(want)
            if not torch.equal(g[p, k], v)]


def close_states(got, want, what):
    """``got`` against ``want`` (TrainState dicts after one step) within
    STATE_FLOOR. Returns the largest share of its bound a leaf used and
    that leaf's name."""
    g = {(p, k): v.float() for p, k, v in state_leaves(got)}
    scale = {}
    for part, _, w in state_leaves(want):
        scale[part] = max(scale.get(part, 0.0), float(w.abs().max()))
    worst, where = 0.0, None
    for part, k, w in state_leaves(want):
        name = f"{part} {k}"
        d = float((g[part, k] - w.float()).abs().max())
        share = d / max(STATE_FLOOR[part] * scale[part], 1e-30)
        check(share <= 1, f"{what}: {name} differs by {d} (share {share} "
              f"of its bound)")
        if share > worst:
            worst, where = share, name
    return worst, where


def same_states(a, b):
    """Two ranks' gathered states are bit-equal (params and EMA)."""
    import torch
    return all(torch.equal(a[part][k], v) for part in ("params",
                                                       "ema_params")
               if b.get(part) is not None for k, v in b[part].items())


def close_losses(got, want, rtol, what, keys=LOSS_KEYS):
    for k in keys:
        g, w = got[k], want[k]
        check(abs(g - w) <= rtol * abs(w) + 1e-7,
              f"{what}: loss {k} {g} against {w}")


def mesh_one_rank(dev, counters):
    """17(a): a (1, 1) mesh over one NCCL rank, against the meshless
    runs, from phase 7's weights on phase 7's stream:
      * MESH_STEPS Trainer steps meshless and on the mesh (checkpoints
        at the last step): every step's losses bit-equal (one state, one
        batch, one set of draws, and a backward that sums in a fixed
        order), every loss finite, B3 launched and B1 and B2 not;
      * MESH_STEPS steps of make_train_step meshless and on the mesh, each
        from the meshless trajectory's state: losses bit-equal, and every
        leaf of the params, the EMA and Adam's moments bit-equal to the
        meshless step's;
      * run_checkpoint_once of the mesh's checkpoint over phase 9's
        fixture, meshless and on the mesh: results JSON equal, B1-B3
        launched 6, 1, 1 times per forward.
    The counters are zeroed just before each run. Returns the numbers
    phase 17 prints."""
    import datetime
    import shutil
    import torch
    import torch.distributed as dist
    from dodt_tpu_torch.models.dt_avod import generator_draws
    from dodt_tpu_torch.parallel import mesh as mesh_lib
    from dodt_tpu_torch.runtime.trainer import (SEED, Trainer,
                                                create_train_state,
                                                make_train_step)

    work = os.path.join(ROOT, "build", "smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    write_eval_fixture(os.path.join(work, "kitti"), EVAL_SPEEDS, EVAL_FRAMES)
    cfg = mesh_cfg()
    model = smoke_model(cfg).to(dev)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "rendezvous"), world_size=1, rank=0,
        timeout=datetime.timedelta(minutes=5))
    runs = {}
    try:
        mesh = mesh_lib.make_mesh(1, 1)
        for name, m in (("meshless", None), ("mesh", mesh)):
            tr = Trainer(cfg, model, SmokeStream(cfg, 7),
                         os.path.join(work, name), mesh=m, metrics_path=None,
                         device=dev)
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            _, hist = tr.train(max_steps=MESH_STEPS, log_every=1)
            torch.cuda.synchronize()
            launches = {c.symbol: c.launches for c in counters}
            ms = np.diff([0.0] + [h["wall_s"] for h in hist]) * 1e3
            runs[name] = {"hist": hist, "ms": ms, "launches": launches,
                          "reduced": tr.step_fn.reduced_bytes}
            check(launches[counters[2].symbol] > 0 and
                  launches[counters[0].symbol] == 0 and
                  launches[counters[1].symbol] == 0,
                  f"{name} training launched {launches}")
            check(all(np.isfinite(h[k]) for h in hist for k in LOSS_KEYS),
                  f"{name} training: losses not finite {hist}")
        one, got = runs["meshless"], runs["mesh"]
        check(all(g[k] == o[k] for g, o in zip(got["hist"], one["hist"])
                  for k in LOSS_KEYS),
              f"Trainer step losses {got['hist']} against {one['hist']}")

        steps = {"meshless": make_train_step(cfg, model),
                 "mesh": make_train_step(cfg, model, mesh)}
        stream = SmokeStream(cfg, 7)
        state = create_train_state(cfg, model)
        for s in range(MESH_STEPS):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in stream.next_batch(1).items()}
            out = {}
            for name, fn in steps.items():
                g = torch.Generator(dev)
                g.manual_seed((SEED << 32) + s)
                out[name] = fn(state, batch, generator_draws(g))
            (a, la), (b, lb) = out["meshless"], out["mesh"]
            check(all(float(la[k]) == float(lb[k]) for k in LOSS_KEYS),
                  f"step {s + 1} from one state: losses {lb} against {la}")
            differ = differing_leaves(b.__dict__, a.__dict__)
            log(f"17(a) step {s + 1} from one state: {len(differ)} leaves "
                f"of the mesh's differ from the meshless step's "
                f"{differ[:4]}")
            check(not differ,
                  f"step {s + 1} from one state is not bit-equal: {differ}")
            state = a
        log(f"17(a) (1, 1) NCCL mesh: {MESH_STEPS} Trainer steps bit-equal "
            f"to the meshless Trainer's, losses "
            f"{[h['total'] for h in got['hist']]}; step ms mesh "
            f"{[round(float(t), 2) for t in got['ms']]}, meshless "
            f"{[round(float(t), 2) for t in one['ms']]}; launches "
            f"{got['launches']}; {MESH_STEPS} steps from one state each: "
            f"losses and every state leaf bit-equal")
        del steps, state, a, b, out

        ecfg = mesh_cfg(work)
        evals = {}
        for name, m in (("meshless", None), ("mesh", mesh)):
            for c in counters:
                c.launches = 0
            evals[name] = mesh_evaluate(
                ecfg, work, os.path.join(work, "mesh"),
                os.path.join(work, f"eval_{name}"), [0],
                None if m is None else (1, 1), dev)
            evals[name]["launches"] = {c.symbol: c.launches
                                       for c in counters}
        n = len(eval_dataset(ecfg, eval_scenes()).couples)
        for name, ev in evals.items():
            # predict_couples([0]) + run_checkpoint_once: n + 1 forwards
            for c, k in zip(counters, (6, 1, 1)):
                check(ev["launches"][c.symbol] == k * (n + 1),
                      f"{name} evaluation launched {ev['launches']}")
        same = json.dumps(evals["mesh"]["results"]) == \
            json.dumps(evals["meshless"]["results"])
        check(same, "the (1, 1) mesh evaluation's results differ from the "
              "meshless run's")
    finally:
        dist.destroy_process_group()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"17(a) evaluation: results JSON equal to the meshless run's; "
        f"{n} couples in {evals['mesh']['wall_s']:.3f} s (meshless "
        f"{evals['meshless']['wall_s']:.3f} s), launches "
        f"{evals['mesh']['launches']}")
    return {"step_ms": float(np.median(got["ms"][1:])),
            "meshless_step_ms": float(np.median(one["ms"][1:])),
            "reduced_bytes": got["reduced"], "flat_bytes": 4 * (
                nparams + len(LOSS_KEYS)),
            "train_launches": got["launches"],
            "eval_launches": evals["mesh"]["launches"], "couples": n,
            "work": work}


def mesh_two_ranks(dev, counters, work):
    """17(b): two ranks on the one card under gloo (NCCL refuses two
    ranks on one GPU), each against this process's meshless run of the
    same program:
      (2, 1): one momentum step at B = 2 (one couple per rank), in f32
              (f32_steps): losses and state against split_step's (the
              two couples' losses and gradients averaged, so a rank that
              kept its own gradient would show), BATCH_FREE_LOSSES
              against the B = 2 step's, and proposal_swaps logged;
      (1, 2): the val forward with the FC trunks sharded over the two
              ranks against the replicated forward (check_tp_forward),
              and one f32 step at B = 1 against the meshless step;
      (2, 1): the Evaluator over phase 9's fixture (eval batch 2, one
              couple per rank per forward) against the meshless one
              (eval batch 1), from 17(a)'s checkpoint.
    Each step is held by check_mesh_step: both ranks' gathered states
    bit-equal, and each within close_states' bounds of one process's.
    Returns the numbers phase 17 prints."""
    import copy
    import dataclasses
    import torch
    from dodt_tpu_torch.parallel import launch

    cfg = mesh_cfg()
    cfg.train.optimizer = dataclasses.replace(cfg.train.optimizer,
                                              name="momentum")
    model = smoke_model(cfg)
    scfg, smodel = f32_steps(cfg)
    batch2 = SmokeStream(cfg, 7).next_batch(2)
    batch1 = SmokeStream(cfg, 8).next_batch(1)
    keys = ("objectness", "rpn_offsets", "top_anchors", "top_valid",
            "final_boxes_3d", "final_scores", "final_valid")
    ecfg = mesh_cfg(work)
    ecfg2 = copy.deepcopy(ecfg)
    ecfg2.eval.batch_size = 2
    n_couples = len(eval_dataset(ecfg, eval_scenes()).couples)
    ckpt = os.path.join(work, "mesh")
    idxs = [0, 1]
    want = {
        "dp_step": launch.train_steps(scfg, smodel, [batch2], device=dev),
        "dp_split": split_step(scfg, smodel, batch2, 2, dev),
        "dp_swaps": proposal_swaps(scfg, smodel, batch2, 2, dev),
        "tp_forward": launch.forward(cfg, model, batch1, keys, device=dev),
        "tp_step": launch.train_steps(scfg, smodel, [batch1], device=dev),
        "evaluate": mesh_evaluate(ecfg, work, ckpt,
                                  os.path.join(work, "eval_one"), idxs,
                                  None, dev)}
    # a fresh process's first step pays for CUDA's lazy module loading and
    # cuDNN's and cuBLAS's set-up (17(a)'s first meshless step: seconds):
    # each rank takes the (2, 1) step once untimed, then again
    programs = [
        ("warm_up", launch.train_steps,
         (scfg, smodel, [batch2], None, (2, 1), dev.type)),
        ("dp_step", launch.train_steps,
         (scfg, smodel, [batch2], None, (2, 1), dev.type)),
        ("tp_forward", launch.forward,
         (cfg, model, batch1, keys, (1, 2), dev.type)),
        ("tp_step", launch.train_steps,
         (scfg, smodel, [batch1], None, (1, 2), dev.type)),
        ("evaluate", mesh_evaluate,
         (ecfg2, work, ckpt, os.path.join(work, "eval_two"), idxs, (2, 1),
          dev.type))]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(card_rank, 2, programs, backend="gloo",
                         timeout_s=MESH_DEADLINE_S)
    log(f"17(b) two gloo ranks ran in {time.perf_counter() - t0:.1f} s")
    res = {"ranks": ranks, "want": want, "couples": n_couples}
    log(f"17(b) the B = 2 train forward against each couple's own, per "
        f"couple (proposal_swaps): {want['dp_swaps']}")
    for r, rank in enumerate(ranks):
        check_mesh_step(f"17(b) rank {r} dp_step", rank["dp_step"],
                        want["dp_step"], want["dp_split"],
                        ranks[0]["dp_step"])
        check_mesh_step(f"17(b) rank {r} tp_step", rank["tp_step"],
                        want["tp_step"], want["tp_step"],
                        ranks[0]["tp_step"])
        check(any(rank["tp_step"]["sharded"].values()),
              "the TP rule sharded nothing at full width")
        check_tp_forward(f"17(b) rank {r}", rank["tp_forward"]["outputs"],
                         want["tp_forward"]["outputs"])
        ev = rank["evaluate"]
        check(json.dumps(ev["results"]) == json.dumps(
            want["evaluate"]["results"]),
            f"rank {r}: the data = 2 evaluation's results differ")
        # each rank forwards one couple of predict_couples' two and of
        # each of run_checkpoint_once's chunks of two
        n_fwd = 1 + n_couples // 2
        for c, k in zip(counters, (6, 1, 1)):
            check(ev["launches"][c.symbol] == k * n_fwd,
                  f"rank {r}: {ev['launches']} in {n_fwd} forwards")
        for name in ("dp_step", "tp_step"):
            check_step_launches(f"rank {r} {name}", rank[name]["launches"],
                                counters)
        log(f"17(b) rank {r}: peak device memory {rank['peak_mib']} MiB,"
            f" evaluation launches {ev['launches']}, train step launches "
            f"{rank['dp_step']['launches']}")
    check(filecmp_tree(os.path.join(work, "eval_one"),
                       os.path.join(work, "eval_two")),
          "the data = 2 evaluation's files differ from the meshless run's")
    return res


def check_mesh_step(what, got, one, ref, rank0):
    """A mesh rank's train_steps result against one process's: losses
    within 1e-3 relative of ``ref``'s, and the state within
    close_states' bounds of it (``ref`` computes the couples as the
    mesh's data ranks do, one by one where they are split, split_step:
    a convolution rounds otherwise at another batch size, and with
    random weights a last-bit change can swap near-tied proposals); the
    BATCH_FREE_LOSSES within 1e-3 of ``one``'s (the same step at the
    global batch in one process); the gathered state bit-equal to rank
    0's."""
    d = {k: abs(got["losses"][0][k] - ref["losses"][0][k])
         / max(abs(ref["losses"][0][k]), 1e-7) for k in LOSS_KEYS}
    log(f"{what}: loss relative differences {d}; step ms {got['ms']} "
        f"(one process {one['ms']}); bytes moved {got['bytes_moved']:.0f},"
        f" all-reduced {got['reduced_bytes']}")
    close_losses(got["losses"][0], ref["losses"][0], 1e-3, what)
    close_losses(got["losses"][0], one["losses"][0], 1e-3,
                 f"{what} against the global batch", BATCH_FREE_LOSSES)
    share, leaf = close_states(got["state"], ref["state"], what)
    log(f"{what}: every leaf within its bound, the largest share of it "
        f"{share:.3g} ({leaf})")
    check(same_states(got["state"], rank0["state"]),
          f"{what}: the state differs from rank 0's")


def check_tp_forward(what, fw, one):
    """The val forward of a mesh against the replicated one: each of the
    RPN's scores and offsets within one bf16 ulp of itself (up to 2^-7 of
    its size; the heads compute in bf16, and a column block's GEMM may
    take another cuBLAS kernel than the full one and round an output
    otherwise) + 1e-5 of their scale, and every top anchor and final box
    of every couple and frame matched."""
    import torch
    for k in ("objectness", "rpn_offsets"):
        d = np.abs(fw[k] - one[k])
        scale = float(np.abs(one[k]).max())
        share = float((d / (2.0 ** -7 * np.abs(one[k]) + 1e-5 * scale))
                      .max())
        log(f"{what} TP forward {k}: max_abs_err {float(d.max()):.4g} of "
            f"{scale:.4g}, the largest share of its bound {share:.3g}")
        check(share <= 1, f"{what} TP forward {k}: {float(d.max())} of "
              f"{scale} (share {share} of its bound)")
    for b in range(fw["top_anchors"].shape[0]):
        for f in range(fw["top_anchors"].shape[1]):
            top = matched_fraction(
                torch.as_tensor(fw["top_anchors"][b, f]),
                torch.as_tensor(one["top_anchors"][b, f]),
                torch.as_tensor(fw["top_valid"][b, f]),
                torch.as_tensor(one["top_valid"][b, f]), 0.05)
            fin = matched_fraction(
                torch.as_tensor(fw["final_boxes_3d"][b, f]),
                torch.as_tensor(one["final_boxes_3d"][b, f]),
                torch.as_tensor(fw["final_valid"][b, f]),
                torch.as_tensor(one["final_valid"][b, f]), 0.1)
            log(f"{what} TP forward couple {b} frame {f}: top_anchors "
                f"matched {top:.3f}, final boxes matched {fin:.3f}")
            check(top == 1.0 and fin == 1.0,
                  f"{what} TP forward couple {b} frame {f}: matched {top}, "
                  f"{fin}")


def check_step_launches(what, got, counters):
    """A train step launched B3 and neither B1 nor B2."""
    check(got[counters[2].symbol] > 0 and not got[counters[0].symbol]
          and not got[counters[1].symbol], f"{what} launched {got}")


def filecmp_tree(a, b):
    """Two directory trees hold the same files, byte for byte."""
    import filecmp
    cmp = filecmp.dircmp(a, b)
    if cmp.left_only or cmp.right_only or cmp.funny_files:
        return False
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    return not mismatch and not errors and all(
        filecmp_tree(os.path.join(a, d), os.path.join(b, d))
        for d in cmp.common_dirs)


# ---------------------------------------------------------------- phase 18

def rest_ops_cuda_vs_cpu(dev):
    """The last ported ops on the card against the CPU at the JAX tests'
    shapes: rotated and 3D IoU matrices (12 x 9 seeded boxes and the
    45-degree square pair), the 3D integral image (10 x 8 x 12) and its
    box query, point projection, the area mask, the metric-to-BEV-pixel
    map; and the metrics helpers on the card: device_sync waits for
    queued work, profile_trace records device kernels. (The BEV-border
    offsets are host numpy code, no device op.)"""
    import tempfile
    import torch
    from dodt_tpu_torch.ops import anchors, iou, projection, voxel, warp
    from dodt_tpu_torch.utils import metrics

    rng = np.random.RandomState(3)

    def bev(n):
        return np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                         rng.uniform(1, 5, n), rng.uniform(1, 3, n),
                         rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)

    def b3d(n):
        b = bev(n)
        return np.stack([b[:, 0], rng.uniform(0.5, 2, n), b[:, 1], b[:, 2],
                         b[:, 3], rng.uniform(1, 2, n), b[:, 4]],
                        1).astype(np.float32)

    worst = {}
    pairs = [(bev(12), bev(9)),
             (np.float32([[0, 0, 2, 2, 0]]),
              np.float32([[0, 0, 2, 2, np.pi / 4]]))]
    for fn, sets in ((iou.rotated_iou_matrix, pairs),
                     (iou.iou_3d_matrix, [(b3d(10), b3d(7))])):
        for a, b in sets:
            g = fn(torch.as_tensor(a, device=dev), torch.as_tensor(b,
                                                                   device=dev))
            c = fn(torch.as_tensor(a), torch.as_tensor(b))
            e = float((g.cpu() - c).abs().max())
            worst[fn.__name__] = max(worst.get(fn.__name__, 0.0), e)
            check(e <= 2e-6, f"{fn.__name__} card vs CPU {e}")
    grid = rng.randint(0, 3, (10, 8, 12)).astype(np.float32)
    lo = np.int64([[2, 1, 3], [0, 0, 0]])
    hi = np.int64([[7, 5, 9], [10, 8, 12]])
    ig = anchors.integral_image_3d(torch.as_tensor(grid, device=dev))
    q = anchors.query_integral_3d(ig, torch.as_tensor(lo, device=dev),
                                  torch.as_tensor(hi, device=dev)).cpu()
    check(torch.equal(ig.cpu(), anchors.integral_image_3d(
        torch.as_tensor(grid))), "integral_image_3d card vs CPU")
    check(q.tolist() == [grid[2:7, 1:5, 3:9].sum(), grid.sum()],
          f"query_integral_3d on the card {q.tolist()}")
    pts = np.stack([rng.uniform(-20, 20, 200), rng.uniform(-2, 2, 200),
                    rng.uniform(5, 60, 200)], 1).astype(np.float32)
    p2 = np.float32([[721.5, 0, 609.5, 44.9], [0, 721.5, 172.8, 0.2],
                     [0, 0, 1.0, 0.003]])
    e, scale = rel_err(projection.project_points_to_image(
        torch.as_tensor(pts, device=dev), p2).cpu(),
        projection.project_points_to_image(torch.as_tensor(pts), p2))
    worst["project_points_to_image"] = e
    check(e <= 1e-5 * scale, f"project_points_to_image card vs CPU {e}")
    valid = rng.rand(200) < 0.9
    ae = ((-4.0, 4.0), (-5.0, 3.0), (0.0, 7.0))
    gp = np.float32([0.0, -1.0, 0.05, 1.65])
    m = voxel.points_in_area_mask(torch.as_tensor(pts, device=dev) / 5,
                                  torch.as_tensor(valid, device=dev), gp, ae)
    check(torch.equal(m.cpu(), voxel.points_in_area_mask(
        torch.as_tensor(pts) / 5, torch.as_tensor(valid), gp, ae)),
        "points_in_area_mask card vs CPU")
    # the full-width BEV map's extents, points on and off the map
    bev_ae = np.float32([[-40.0, 40.0], [0.0, 70.0]])
    xz = [torch.as_tensor(rng.uniform(lo - 5, hi + 5, 500).astype(
        np.float32)) for lo, hi in bev_ae]
    got = warp.bev_pixel_from_xz(xz[0].to(dev), xz[1].to(dev), bev_ae, 350,
                                 400)
    want = warp.bev_pixel_from_xz(xz[0], xz[1], bev_ae, 350, 400)
    e = max(float((g.cpu() - c).abs().max()) for g, c in zip(got, want))
    worst["bev_pixel_from_xz"] = e
    # a few f32 ulps of a 400-pixel coordinate
    check(e <= 1e-6 * 400, f"bev_pixel_from_xz card vs CPU {e}")

    # metrics: a queued 100 ms sleep is over when device_sync returns
    x = torch.ones(1, device=dev)
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES * 20)
    metrics.device_sync({"x": [x]})
    waited = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        with metrics.profile_trace(d):
            (torch.ones(512, 512, device=dev) @ torch.ones(
                512, 512, device=dev)).sum().item()
        with open(os.path.join(d, "trace.json")) as f:
            trace = json.load(f)
    kernels = sum(1 for e in trace.get("traceEvents", [])
                  if e.get("cat") == "kernel")
    log(f"phase 18: card vs CPU max abs errors {worst}; device_sync waited "
        f"{waited * 1e3:.1f} ms for the queued sleep, profile_trace "
        f"recorded {kernels} device kernels")
    check(waited >= 0.05, "device_sync returned before the queued work ended")
    check(kernels > 0, "profile_trace recorded no device kernel")
    return worst


# ---------------------------------------------------------------- phase 20

def voxel_edge_points(ku):
    """(P, 3) points on every x edge of the BEV grid (at z = 35.05) and
    every z edge (at x = 0.05), each at the height-slice edges above the
    plane y = 1.65 and between them: the f32 nearest each edge."""
    bg = ku.bev_generator
    area = np.asarray(ku.area_extents, np.float64)
    vs = ku.voxel_size

    def edges(lo, hi):
        n = int(round((hi - lo) / vs))
        return np.float32(lo + vs * np.arange(1, n, dtype=np.float64))

    div = (bg.height_hi - bg.height_lo) / bg.num_slices
    ys = np.float32(EDGE_PLANE[3] - (bg.height_lo + div * np.arange(
        0.0, bg.num_slices, 0.5)))
    xs, zs = edges(*area[0]), edges(*area[2])
    strip_x = np.stack(np.broadcast_arrays(
        xs[:, None], ys[None, :], np.float32(35.05)), -1).reshape(-1, 3)
    strip_z = np.stack(np.broadcast_arrays(
        np.float32(0.05), ys[None, :], zs[:, None]), -1).reshape(-1, 3)
    return np.concatenate([strip_x, strip_z]).astype(np.float32)


EDGE_PLANE = np.float32([0.0, -1.0, 0.0, 1.65])
# a ground plane as KITTI's are, off the axes: the plane offset's FMAs
# (dodt_tpu_torch/ops/voxel.py plane_offset) set the heights and slices
TILTED_PLANE = np.float32([-0.0077, -0.9999, 0.0116, 1.6512])


def rasterization_cuda_vs_cpu(dev):
    """The full-width BEV rasterization on the card against the CPU, bit
    for bit: bench's points (make_batch, seed 0, both frames, on bench's
    plane and on TILTED_PLANE) and points on every cell and slice edge
    (voxel_edge_points). The val forward and the train step take this
    one form (ROADMAP C24). Also counts the
    edge coordinates whose cell the division (x - lo) / voxel_size
    gives differently on the card (a CUDA tensor divided by a Python
    number is multiplied by its f32 reciprocal, as jitted XLA) and on
    the CPU (the true quotient)."""
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.ops.voxel import bev_maps_from_points

    cfg = cars_dt_tracking()
    cfg.dataset.max_points = 65536
    ku = cfg.dataset.kitti_utils
    bg = ku.bev_generator
    batch = make_batch(cfg, np.random.RandomState(0))
    edges = voxel_edge_points(ku)
    clouds = {f"bench frame {f}{tag}": (batch["points"][0, f],
                                        batch["points_valid"][0, f], gp)
              for f in range(2)
              for tag, gp in (("", batch["ground_plane"][0]),
                              (" tilted", TILTED_PLANE))}
    clouds["edges"] = (edges, np.ones(len(edges), bool), EDGE_PLANE)
    cells = {}
    for name, (pts, valid, gp) in clouds.items():
        maps = [bev_maps_from_points(
            torch.as_tensor(pts, device=d), torch.as_tensor(valid, device=d),
            torch.as_tensor(gp, device=d), ku.area_extents, ku.voxel_size,
            bg.height_lo, bg.height_hi, bg.num_slices) for d in (dev, "cpu")]
        f_diff = int((maps[0].features.cpu() != maps[1].features).sum())
        o_diff = int((maps[0].occupancy.cpu() != maps[1].occupancy).sum())
        cells[name] = int(maps[1].occupancy.sum())
        log(f"phase 20 {name}: {len(pts)} points, {cells[name]} occupied "
            f"cells, card vs CPU: {f_diff} feature values and {o_diff} "
            f"occupancy cells differ")
        check(f_diff == 0 and o_diff == 0,
              f"rasterization of {name} card vs CPU: {f_diff} feature "
              f"values, {o_diff} occupancy cells differ")
    moved = 0
    for axis in (0, 2):
        v = torch.as_tensor(edges[:, axis]) - float(ku.area_extents[axis][0])
        cpu = torch.floor(v / ku.voxel_size)
        card = torch.floor(v.to(dev) / ku.voxel_size).cpu()
        moved += int((cpu != card).sum())
    log(f"phase 20: dividing by the voxel size puts {moved} of "
        f"{2 * len(edges)} edge coordinates in another cell on the card "
        f"than on the CPU")
    return {"edge_points": len(edges), "moved_by_division": moved,
            "cells": cells}


# ---------------------------------------------------------------- phase 21

# the flagship's bf16 forward, card against CPU (tests/
# test_torch_full_width_forward.py's bf16 rule): the share of the CPU's
# valid top proposals with a card proposal within 5e-2 (m, over the six
# anchor values) and 1e-2 in score, and the largest difference of the
# valid final counts as a share of the CPU's
FLAGSHIP_TOP = (5e-2, 0.98)
FLAGSHIP_COUNT_SHARE = 0.2


def flagship_forward_cuda_vs_cpu(dev):
    """The full-width monolithic forward of cars_dt_tracking (bf16
    towers, init_params seed 0, bench's couple) on the card and on the
    CPU with the same weights: bev_input bit-equal, the top proposals
    matched as sets, the valid final counts close; the finals' set
    shares within 1e-2 and 0.5 logged."""
    import copy
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params

    cfg = cars_dt_tracking()
    cfg.dataset.max_points = 65536
    check(cfg.model.tower_dtype == "bfloat16", "the flagship's towers")
    cpu_model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(cpu_model, torch.Generator().manual_seed(0))
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    host = make_batch(cfg, np.random.RandomState(0))
    og = gpu_model({k: torch.as_tensor(v, device=dev)
                    for k, v in host.items()})
    t0 = time.perf_counter()
    oc = cpu_model({k: torch.as_tensor(v) for k, v in host.items()})
    cpu_s = time.perf_counter() - t0
    check_forward(og, 1, cfg)
    og = {k: v.cpu() for k, v in og.items() if v is not None}
    diff = int((og["bev_input"] != oc["bev_input"]).sum())
    check(diff == 0, f"flagship bev_input card vs CPU: {diff} values differ")
    res = {"cpu_forward_s": cpu_s, "frames": []}
    for f in range(2):
        def rows(o, boxes, scores):
            return torch.cat([o[boxes][0, f], o[scores][0, f, :, None]], -1)
        top = matched_fraction(
            rows(oc, "top_anchors", "top_scores"),
            rows(og, "top_anchors", "top_scores"), oc["top_valid"][0, f],
            og["top_valid"][0, f], FLAGSHIP_TOP[0])
        vc, vg = oc["final_valid"][0, f], og["final_valid"][0, f]
        fin = [matched_fraction(rows(oc, "final_boxes_3d", "final_scores"),
                                rows(og, "final_boxes_3d", "final_scores"),
                                vc, vg, tol) for tol in (1e-2, 0.5)]
        nc, ng = int(vc.sum()), int(vg.sum())
        res["frames"].append({"top_share": top, "valid_cpu": nc,
                              "valid_card": ng, "final_share_1e-2": fin[0],
                              "final_share_0.5": fin[1]})
        log(f"phase 21 frame {f}: top proposals matched within "
            f"{FLAGSHIP_TOP[0]} {top:.4f}; valid finals card {ng} CPU {nc}; "
            f"finals matched within 1e-2 {fin[0]:.4f}, within 0.5 "
            f"{fin[1]:.4f}")
        check(top >= FLAGSHIP_TOP[1], f"frame {f}: top proposals {top}")
        check(nc > 0 and abs(ng - nc) <= FLAGSHIP_COUNT_SHARE * nc,
              f"frame {f}: valid final counts card {ng} CPU {nc}")
    return res


# ---------------------------------------------------------------- phase 22

# the full-width f32 train step, card against CPU: losses relative, every
# gradient as a share of its leaf's largest; a bias ahead of a
# one-channel GroupNorm has an exact gradient of 0 and is held to a share
# of the model's largest. Measured on the card (NVIDIA H100 80GB HBM3,
# 700.00 W, TF32 off): losses 3.1e-6 (avod_ang), gradients 1.8e-4
# (avod_fc.fc2.weight)
STEP22_LOSS_RTOL = 1e-4
STEP22_GRAD_SHARE = 2e-3
STEP22_NOISE_SHARE = 1e-4


def train_step_full_width_cuda_vs_cpu(dev, counters):
    """One make_train_step of cars_dt_tracking at full width with f32
    towers on the card and on the CPU: phase 7's weights (init_params seed
    0, rpn_reg's output scaled by 1e-2) and couple (SmokeStream(cfg, 7)'s
    first), the same draws (a seeded CPU generator, each draw made once
    and handed to both), train=True with the RPN head's dropout off (as
    tests/test_torch_full_width_train.py (c) holds the CPU step to JAX's),
    SGD at lr 1 without clipping, so each update is minus the gradient. The
    forward's outputs are read through a hook: bev_input bit-equal, the
    anchor and proposal masks and the RPN mini-batch's selection exact;
    the losses and every gradient within STEP22_*. On the card the step
    runs twice: a warm-up, then the timed one with the counters zeroed,
    in which B3 must launch once and its backward (corr_bottleneck_vjp)
    run once. Returns the card step's ms, peak MiB, B3's launches and the
    measured differences."""
    import copy
    import torch
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    from dodt_tpu_torch.ops import correlation
    from dodt_tpu_torch.runtime.trainer import (create_train_state,
                                                make_train_step)

    cfg = cars_dt_tracking()
    cfg.dataset.max_points = 65536
    cfg.model.tower_dtype = "float32"
    cfg.model.rpn.keep_prob = 1.0
    opt = cfg.train.optimizer
    opt.name, opt.initial_lr, opt.grad_clip_norm = "sgd", 1.0, 1e30
    cpu_model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(cpu_model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu_model.rpn_reg.out.weight.mul_(1e-2)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    host = SmokeStream(cfg, 7).next_batch(1)
    cache = {}
    g = torch.Generator().manual_seed(1)

    def rand(name, shape):                       # the same draws for both
        if (name, shape) not in cache:
            cache[name, shape] = torch.rand(shape, generator=g)
        return cache[name, shape]

    vjp = correlation.corr_bottleneck_vjp
    vjp_calls = []

    def counted_vjp(*args, **kw):
        vjp_calls.append(1)
        return vjp(*args, **kw)

    def step_on(model, d, card):
        outs = []
        hook = model.register_forward_hook(
            lambda m, a, kw, out: outs.append(out), with_kwargs=True)
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, model)
        batch = {k: torch.as_tensor(v, device=d) for k, v in host.items()}
        draws = (lambda n, sh: rand(n, sh).to(d))
        ms = None
        for run in range(2 if card else 1):
            outs.clear()
            if card and run == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                for c in counters:
                    c.launches = 0
                vjp_calls.clear()
                t0 = time.perf_counter()
            new, losses = step(state, batch, draws)
            if card and run == 1:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        hook.remove()
        out = outs[-1]
        keep = {k: out[k].detach().cpu() for k in
                ("bev_input", "anchor_valid", "top_valid")}
        keep.update({f"rpn_mb.{k}": out["rpn_mb"][k].cpu()
                     for k in ("sel", "pos")})
        grads = {k: (state.params[k] - new.params[k]).cpu()
                 for k in state.params}
        return ({k: float(v) for k, v in losses.items()}, grads, keep, ms)

    correlation.corr_bottleneck_vjp = counted_vjp
    try:
        lg, gg, og, ms = step_on(gpu_model, dev, True)
    finally:
        correlation.corr_bottleneck_vjp = vjp
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    launches = {c.symbol: c.launches for c in counters}
    b3 = correlation._KERNEL.launches
    others = [c.launches for c in counters if c is not correlation._KERNEL]
    t0 = time.perf_counter()
    lc, gc, oc, _ = step_on(cpu_model, "cpu", False)
    cpu_s = time.perf_counter() - t0
    log(f"phase 22: full-width f32 train step on the card {ms:.2f} ms, peak "
        f"device memory {peak:.0f} MiB, B3 launches {b3}, its backward "
        f"{len(vjp_calls)}; on the CPU {cpu_s:.1f} s")
    check(b3 == 1 and len(vjp_calls) == 1,
          f"B3 launched {b3} times and its backward ran {len(vjp_calls)} "
          f"times in the card's train step")
    check(others == [0, 0], f"an eval-only kernel ran in training: {others}")
    for k in oc:
        diff = int((og[k] != oc[k]).sum())
        check(diff == 0, f"phase 22 {k} card vs CPU: {diff} values differ")
    log("phase 22 losses card " + ", ".join(
        f"{k} {lg[k]:.6g}" for k in LOSS_KEYS) + " | cpu " + ", ".join(
        f"{k} {lc[k]:.6g}" for k in LOSS_KEYS))
    rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30)
           for k in LOSS_KEYS}
    top = max(float(v.abs().max()) for v in gc.values())
    shares = {}
    for k, want in gc.items():
        e, scale = rel_err(gg[k], want)
        shares[k] = (e / top if scale < STEP22_NOISE_SHARE * top
                     else e / scale)
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:4]
    log(f"phase 22: loss relative differences {rel}; largest gradient "
        f"differences (share of the leaf's largest, or of the model's for "
        f"a zero-gradient leaf) {worst}")
    for k in LOSS_KEYS:
        check(lc[k] > 0, f"phase 22: loss {k} is zero")
        check(rel[k] <= STEP22_LOSS_RTOL,
              f"phase 22 loss {k}: card {lg[k]} CPU {lc[k]}")
    for k, want in gc.items():
        e, scale = rel_err(gg[k], want)
        if scale < STEP22_NOISE_SHARE * top:
            check(e <= STEP22_NOISE_SHARE * top,
                  f"phase 22 gradient {k}: {e} vs the model's {top}")
        else:
            check(e <= STEP22_GRAD_SHARE * scale,
                  f"phase 22 gradient {k}: {e} vs {scale}")
    return {"step_ms": ms, "peak_mib": peak, "b3_launches": b3,
            "launches": launches, "cpu_step_s": cpu_s, "loss_rel": rel,
            "worst_grads": worst}


# ---------------------------------------------------------------- phase 19

def mesh_cards(dev, counters, n):
    """Phase 19, run by ``chip_smoke.py --mesh-cards`` on a host of ``n``
    cards (n even, at least 4) and not in the one-card run: the mesh over
    NCCL, one rank per card, at full width from phase 7's weights, each
    program against this process's run of it on card 0:
      (n/2, 2): one f32 momentum step at B = n/2 (f32_steps;
                check_mesh_step: losses and state against
                split_step's, BATCH_FREE_LOSSES against one card's
                B = n/2 step's, every rank's gathered state bit-equal to
                rank 0's);
      (n/2, 2): the val forward of those n/2 couples, the FC trunks
                sharded over 'model', against one card's forward of each
                couple (check_tp_forward);
      (n/2, 2): MESH_STEPS Adam steps with the Trainer's draws (each
                program makes its own process groups, so its first step
                pays for NCCL's communicator set-up; steps 2 on are the
                timed ones): losses
                finite, the first step's within 1e-3 of split_step's
                (BATCH_FREE_LOSSES of one card's B = n/2 step's too),
                and every rank's state bit-equal to rank 0's after the
                last (later steps are not compared with one card's: the
                mesh's sums in another order part the states in the
                last bits, and with random weights a last-bit change can
                swap near-tied proposals);
      (n, 1):   the Evaluator over phase 9's fixture (eval batch n, one
                couple per rank per forward) against the meshless one
                (eval batch 1), from a checkpoint of phase 7's weights:
                results JSON and files equal.
    Every collective of the mesh runs here over NCCL: the gradient
    all-reduces over 'data' and over 'model', the clip's norm, the TP
    gathers and their backward all-reduces, the broadcast of the
    replicated state, the evaluator's gathers. Then torchrun_train: the
    CLI's train command under torchrun on the n cards. Returns the
    numbers the mode prints."""
    import copy
    import dataclasses
    import shutil
    import torch
    from dodt_tpu_torch.parallel import launch
    from dodt_tpu_torch.runtime.trainer import (CheckpointIO,
                                                create_train_state)

    nd = n // 2
    work = os.path.join(ROOT, "build", "smoke_cards")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    write_eval_fixture(os.path.join(work, "kitti"), EVAL_SPEEDS, EVAL_FRAMES)
    cfg = mesh_cfg()
    mom = copy.deepcopy(cfg)
    mom.train.optimizer = dataclasses.replace(cfg.train.optimizer,
                                              name="momentum")
    model = smoke_model(cfg)
    mom, smodel = f32_steps(mom)
    ckpt = os.path.join(work, "ckpt")
    CheckpointIO(ckpt).save(MESH_STEPS, create_train_state(cfg, model))
    batch = SmokeStream(cfg, 7).next_batch(nd)
    stream = SmokeStream(cfg, 9)
    adam_batches = [stream.next_batch(nd) for _ in range(MESH_STEPS)]
    keys = ("objectness", "rpn_offsets", "top_anchors", "top_valid",
            "final_boxes_3d", "final_scores", "final_valid")
    ecfg = mesh_cfg(work)
    ecfg_n = copy.deepcopy(ecfg)
    ecfg_n.eval.batch_size = n
    n_couples = len(eval_dataset(ecfg, eval_scenes()).couples)
    idxs = [0, 1]
    # this process's first f32 step pays for cuDNN's and cuBLAS's set-up:
    # it is taken once untimed
    launch.train_steps(mom, smodel, [batch], device=dev)
    # each data rank forwards one couple: the reference forwards them one
    # by one too (a bf16 convolution rounds otherwise at another batch)
    one = [launch.forward(cfg, model, {k: v[i:i + 1] for k, v in
                                       batch.items()}, keys, device=dev)
           for i in range(nd)]
    want = {
        "step": launch.train_steps(mom, smodel, [batch], device=dev),
        "split": split_step(mom, smodel, batch, nd, dev),
        "forward": {"outputs": {k: np.concatenate([o["outputs"][k]
                                                   for o in one])
                                for k in keys}},
        "adam": launch.train_steps(cfg, model, adam_batches, device=dev),
        "adam_split": split_step(cfg, model, adam_batches[0], nd, dev),
        "evaluate": mesh_evaluate(ecfg, work, ckpt,
                                  os.path.join(work, "eval_one"), idxs,
                                  None, dev)}
    model.cpu()
    smodel.cpu()
    shape = (nd, 2)
    # the first step of a fresh process pays for CUDA's lazy module
    # loading and the libraries' set-up: each rank takes it once untimed
    programs = [
        ("warm_up", launch.train_steps,
         (mom, smodel, [batch], None, shape, "cuda")),
        ("step", launch.train_steps,
         (mom, smodel, [batch], None, shape, "cuda")),
        ("forward", launch.forward, (cfg, model, batch, keys, shape,
                                     "cuda")),
        ("adam", launch.train_steps,
         (cfg, model, adam_batches, None, shape, "cuda")),
        ("evaluate", mesh_evaluate,
         (ecfg_n, work, ckpt, os.path.join(work, "eval_cards"), idxs,
          (n, 1), "cuda"))]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(card_rank, n, programs, backend="nccl",
                         timeout_s=MESH_CARDS_DEADLINE_S)
    log(f"19 {n} NCCL ranks ran in {time.perf_counter() - t0:.1f} s")
    for r, rank in enumerate(ranks):
        check_mesh_step(f"19 rank {r} step", rank["step"], want["step"],
                        want["split"], ranks[0]["step"])
        check(rank["step"]["bytes_moved"] > 0 and
              rank["forward"]["bytes_moved"] > 0,
              f"rank {r}: no bytes moved")
        check(any(rank["step"]["sharded"].values()),
              "the TP rule sharded nothing at full width")
        check_tp_forward(f"19 rank {r}", rank["forward"]["outputs"],
                         want["forward"]["outputs"])
        adam = rank["adam"]
        check(all(np.isfinite(v) for h in adam["losses"]
                  for v in h.values()), f"rank {r}: Adam losses "
              f"{adam['losses']}")
        close_losses(adam["losses"][0], want["adam_split"]["losses"][0],
                     1e-3, f"19 rank {r} Adam step 1")
        close_losses(adam["losses"][0], want["adam"]["losses"][0], 1e-3,
                     f"19 rank {r} Adam step 1 against the global batch",
                     BATCH_FREE_LOSSES)
        check(same_states(adam["state"], ranks[0]["adam"]["state"]),
              f"rank {r}: the state after {MESH_STEPS} Adam steps differs "
              f"from rank 0's")
        ev = rank["evaluate"]
        check(json.dumps(ev["results"]) == json.dumps(
            want["evaluate"]["results"]),
            f"rank {r}: the data = {n} evaluation's results differ")
        # one couple per rank in predict_couples' forward and in each of
        # run_checkpoint_once's chunks of n
        n_fwd = 1 + -(-n_couples // n)
        for c, k in zip(counters, (6, 1, 1)):
            check(ev["launches"][c.symbol] == k * n_fwd,
                  f"rank {r}: {ev['launches']} in {n_fwd} forwards")
        for name in ("step", "adam"):
            check_step_launches(f"rank {r} {name}", rank[name]["launches"],
                                counters)
        log(f"19 rank {r}: Adam step ms {adam['ms']} (one card "
            f"{want['adam']['ms']}), bytes moved per step "
            f"{adam['bytes_moved']:.0f}, all-reduced "
            f"{adam['reduced_bytes']}; peak device memory "
            f"{rank['peak_mib']} MiB; evaluation launches {ev['launches']}")
    check(filecmp_tree(os.path.join(work, "eval_one"),
                       os.path.join(work, "eval_cards")),
          f"the data = {n} evaluation's files differ from the meshless "
          f"run's")
    cli_runs = torchrun_train(work, n)
    shutil.rmtree(work, ignore_errors=True)
    return {"ranks": ranks, "want": want, "couples": n_couples,
            "torchrun": cli_runs}


# chip_smoke.py --mesh-cards: the documented multi-card training command
TORCHRUN_TIMEOUT_S = 300
# Written into a directory on the PYTHONPATH of the command's processes:
# write_eval_fixture writes no PNGs, and the card's machine has no cv2.
FLAT_CARD_HOOK = '''"""Imported at start-up by every process whose PYTHONPATH holds this
directory: runs the environment's own sitecustomize, if there is one,
then gives KittiTrackingDataset write_eval_fixture's flat gray cards as
its camera images (chip_smoke.use_flat_cards)."""
import importlib.machinery
import importlib.util
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path
                      if os.path.abspath(p or os.curdir) != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))

import chip_smoke  # noqa: E402

chip_smoke.use_flat_cards()
'''


def use_flat_cards():
    """KittiTrackingDataset's camera images, in this process, are the
    flat gray cards of write_eval_fixture's scenes (eval_scenes), as
    cv2 would read and resize them from the PNGs."""
    from dodt_tpu_torch.data.tracking import KittiTrackingDataset
    scenes = eval_scenes()

    def flat_cards(self, video_id, frame):
        return flat_card(scenes[video_id].image_at(frame),
                         self.cfg.image_shape)
    KittiTrackingDataset._camera_image = flat_cards


def printed_history(text):
    """The losses cli.py train prints (its history's last entries)."""
    return json.loads(text[text.index("[\n"):text.index("\n]\n") + 2])


def torchrun_train(work, n):
    """``torchrun --standalone --nproc_per_node n -m dodt_tpu_torch.cli
    train --num_model 2`` (README, cli.py) at full width over
    write_eval_fixture's files under ``work`` (phase 16's config:
    cars_dt_tracking(data_stride=3) at 65536 points, video 0 training),
    global batch n / 2: one step, then a second run of the same command
    to step 2, which resumes from the first's checkpoint (the CLI logs
    one mean per run of up to 10 steps, so one run a step gives each
    step's losses). Against it, the one-card command ``python -m
    dodt_tpu_torch.cli train --batch_size n / 2 --max_steps 1``: losses
    finite, the first step's within 1e-3 of one card's (phase 19's
    bound), and the checkpoint of step 2 restores into a meshless model
    and train state. Every process reads the fixture's flat gray cards
    (FLAT_CARD_HOOK). Returns the numbers the mode prints."""
    import torch
    from dodt_tpu_torch import cli
    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.runtime.trainer import (CheckpointIO,
                                                create_train_state)

    cfg = eval_cfg(cars_dt_tracking(data_stride=3),
                   os.path.join(work, "kitti"))
    cfg.dataset.max_points = 65536
    cfg.dataset.video_train_ids = (0,)
    cfg_path = os.path.join(work, "cli_cfg.json")
    cfg.save(cfg_path)
    hook = os.path.join(work, "hook")
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(FLAT_CARD_HOOK)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([hook, ROOT])}
    args = ["train", "--config", cfg_path, "--batch_size", str(n // 2)]
    cards, one = (os.path.join(work, d) for d in ("cli_cards", "cli_one"))
    torchrun = [os.path.join(os.path.dirname(sys.executable), "torchrun"),
                "--standalone", "--nproc_per_node", str(n), "-m",
                "dodt_tpu_torch.cli"]
    runs = {}
    torch.cuda.empty_cache()
    for name, cmd in (
            ("step 1", torchrun + args + ["--ckpt_dir", cards,
                                          "--num_model", "2",
                                          "--max_steps", "1"]),
            ("step 2", torchrun + args + ["--ckpt_dir", cards,
                                          "--num_model", "2",
                                          "--max_steps", "2"]),
            ("one card", [sys.executable, "-m", "dodt_tpu_torch.cli"]
             + args + ["--ckpt_dir", one, "--max_steps", "1"])):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=TORCHRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"19 torchrun {name}: exit "
              f"{p.returncode}\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        hist = printed_history(p.stdout)
        check(len(hist) == 1 and all(np.isfinite(hist[0][k])
                                     for k in LOSS_KEYS),
              f"19 torchrun {name}: losses {hist}")
        runs[name] = {"losses": hist[0], "wall_s": wall}
        log(f"19 torchrun {name}: {' '.join(cmd[1:])}: losses "
            f"{hist[0]}, wall {wall:.1f} s")
    close_losses(runs["step 1"]["losses"], runs["one card"]["losses"], 1e-3,
                 "19 torchrun step 1")
    _, _, model = cli._build(cfg_path, "train")
    io = CheckpointIO(cards)
    check(io.all_steps() == [1, 2], f"19 torchrun checkpoints "
          f"{io.all_steps()}")
    state = io.restore_state(create_train_state(cfg, model), 2)
    model.load_state_dict(state.params)
    check(state.step == 2 and all(bool(torch.isfinite(v).all())
                                  for _, _, v in state_leaves(
                                      state.__dict__)),
          f"19 torchrun: the checkpoint of step {state.step} is not finite")
    log("19 torchrun: the checkpoint of step 2 restores into a meshless "
        "model and train state")
    return runs


def mesh_cards_main():
    """``--mesh-cards``: phase 1's build, then phase 19 on every card of
    the host; prints its numbers, the card's name and power limit, and
    the device line."""
    import torch
    n = torch.cuda.device_count()
    if n < 4 or n % 2:
        return fail(f"--mesh-cards needs an even number of cards, at "
                    f"least 4; this host has {n}")
    sys.path.insert(0, ROOT)
    try:
        from dodt_tpu_torch.ops import _cuda, conv_chain, correlation
        from dodt_tpu_torch.ops import roi_window
    except ImportError as exc:
        return fail(f"cannot import the port ({exc}); run it from the "
                    "repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    counters = [conv_chain._KERNEL, roi_window._KERNEL, correlation._KERNEL]
    try:
        t0 = time.perf_counter()
        lib, _ = _cuda.build()
        _cuda.load()
        log(f"phase 1: built {os.path.relpath(lib, ROOT)} in "
            f"{time.perf_counter() - t0:.1f} s")
        res = mesh_cards(dev, counters, n)
        log(f"phase 19: the ({n // 2}, 2) and ({n}, 1) NCCL meshes equal "
            f"one card")
    except PhaseError as exc:
        return fail(str(exc))
    except Exception as exc:
        import traceback
        traceback.print_exc()
        return fail(f"{type(exc).__name__}: {exc}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr}")
    cards = smi.stdout.strip().splitlines()
    want = res["want"]
    for r, rank in enumerate(res["ranks"]):
        st, adam = rank["step"], rank["adam"]
        print(f"mesh ({n // 2}, 2) rank {r} of {n} (NCCL, one card each): "
              f"Adam step ms at B = {n // 2} (bf16, median of steps "
              f"2-{MESH_STEPS}) {np.median(adam['ms'][1:]):.4f} (one card "
              f"{np.median(want['adam']['ms'][1:]):.4f}), every step "
              f"{[round(t, 4) for t in adam['ms']]}, bytes moved per step "
              f"{adam['bytes_moved']:.0f}; f32 momentum step ms (the first "
              f"on its process groups) {st['ms'][0]:.4f} (one card "
              f"{want['step']['ms'][0]:.4f}), bytes moved "
              f"{st['bytes_moved']:.0f}; TP forward "
              f"bytes moved {rank['forward']['bytes_moved']:.0f}; "
              f"evaluation s {rank['evaluate']['wall_s']:.4f} (one card "
              f"{want['evaluate']['wall_s']:.4f}); launches per step "
              f"{st['launches']}, per evaluation "
              f"{rank['evaluate']['launches']}; peak device memory "
              f"{rank['peak_mib']:.0f} MiB on "
              f"{cards[r % len(cards)]}")
    tr = res["torchrun"]
    print(f"torchrun --nproc_per_node {n} -m dodt_tpu_torch.cli train "
          f"--num_model 2 (full width, global batch {n // 2}): step 1 total "
          f"loss {tr['step 1']['losses']['total']:.6g} (one card "
          f"{tr['one card']['losses']['total']:.6g}), step 2 "
          f"{tr['step 2']['losses']['total']:.6g}; command wall s "
          f"{tr['step 1']['wall_s']:.1f} and {tr['step 2']['wall_s']:.1f} "
          f"(one card {tr['one card']['wall_s']:.1f}) on {cards[0]}")
    print(cards[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}))
    return 0


# ---------------------------------------------------------------- main

# kernel_times of the tree in the working directory, timed by the
# chip_smoke.py named in argv[1]
KERNEL_TIMES = (
    "import importlib.util, json, sys, torch; sys.path.insert(0, '.'); "
    "spec = importlib.util.spec_from_file_location('timing', sys.argv[1]); "
    "cs = importlib.util.module_from_spec(spec); "
    "spec.loader.exec_module(cs); "
    "from dodt_tpu_torch.ops import _cuda; _cuda.load(); "
    "torch.backends.cuda.matmul.allow_tf32 = False; "
    "torch.backends.cudnn.allow_tf32 = False; "
    "r = cs.kernel_times(torch.device('cuda', 0)); "
    "print('KERNELS ' + json.dumps(r))")


def compare_kernels(other):
    """kernel_times of the tree at ``other`` (an unpacked parent commit)
    and of this tree, both timed by this file's code, each tree in a
    process of its own with its own kernel build, in turns: other, this,
    this, other. Prints each kernel's and library call's ms, device_ms
    and host_us per run."""
    runs = []
    for d in (other, ROOT, ROOT, other):
        p = subprocess.run([sys.executable, "-c", KERNEL_TIMES,
                            os.path.abspath(__file__)], cwd=d,
                           capture_output=True, text=True, timeout=1200)
        found = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("KERNELS ")]
        if p.returncode or not found:
            log(f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
            return fail(f"compare: kernel times of {d} failed (exit "
                        f"{p.returncode})")
        runs.append(json.loads(found[-1][len("KERNELS "):]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "card not read"
    for name in runs[0]:
        for key in ("ms", "device_ms", "host_us", "library_ms",
                    "library_device_ms", "library_host_us"):
            if all(r[name][key] is not None for r in runs):
                print(f"{name} {key} (other, this, this, other): "
                      + ", ".join(f"{r[name][key]:.4f}" for r in runs)
                      + f" on {card}")
    print(json.dumps({"compare_kernels": runs, "card": card}))
    return 0


def main():
    import shutil
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; this script runs "
                    "only on a CUDA card")
    if sys.argv[1:2] == ["--compare-kernels"] and len(sys.argv) == 3:
        return compare_kernels(os.path.abspath(sys.argv[2]))
    if sys.argv[1:] == ["--mesh-cards"]:
        return mesh_cards_main()
    sys.path.insert(0, ROOT)
    try:
        from dodt_tpu_torch.ops import _cuda, conv_chain, correlation, nms
        from dodt_tpu_torch.ops import roi_window
    except ImportError as exc:
        return fail(f"cannot import the port ({exc}); run it from the "
                    "repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    counters = [conv_chain._KERNEL, roi_window._KERNEL, correlation._KERNEL]
    sources = {"conv_chain": ("dodt_tpu_torch/csrc/conv_chain.cu",
                              "dodt_tpu/ops/conv_chain.py:138",
                              conv_chain._KERNEL),
               "roi_window": ("dodt_tpu_torch/csrc/roi_window.cu",
                              "dodt_tpu/ops/roi_pallas.py:76",
                              roi_window._KERNEL),
               "corr_bottleneck": ("dodt_tpu_torch/csrc/correlation.cu",
                                   "dodt_tpu/ops/correlation.py:214",
                                   correlation._KERNEL),
               "correlation_cf": ("dodt_tpu_torch/csrc/correlation_cf.cu",
                                  "dodt_tpu/ops/correlation.py:110",
                                  correlation._CF_KERNEL),
               "nms_fixpoint": ("dodt_tpu_torch/csrc/nms_fixpoint.cu",
                                "none: JAX's lax.while_loop, dodt_tpu/ops/"
                                "nms.py nms_bev_exact", nms._KERNEL)}
    with_nms = [*counters, nms._KERNEL]
    try:
        t0 = time.perf_counter()
        lib, compiler_output = _cuda.build()
        _cuda.load()
        log(f"phase 1: built {os.path.relpath(lib, ROOT)} in "
            f"{time.perf_counter() - t0:.1f} s\n{compiler_output}")
        spilled = spills(compiler_output)
        check(not spilled, f"kernels spill registers: {spilled}")
        kern = kernel_checks(dev)
        kern["nms_fixpoint"] = nms_kernel_checks(dev)
        log("phase 2: kernels agree with their twins")
        cfg, model, batch = full_width(dev)
        times, launches, pushes = full_slice(cfg, model, batch, with_nms)
        log("phase 3: full-width slice ran on both arms")
        cuda_vs_cpu(dev)
        log("phase 4: CUDA slice agrees with the CPU slice")
        pair_ms, fwd_launches, fwd_calls = pair_forward(cfg, model, batch,
                                                        with_nms)
        stage = second_stage_times(model, batch)
        del model
        op_launches = correlation_op(dev, correlation._CF_KERNEL)
        log("phase 5: full-width pair forward and B4's public op ran")
        forward_cuda_vs_cpu(dev)
        log("phase 6: CUDA pair forward agrees with the CPU forward")
        step_ms, peak_mib, train_launches, ckpt, grads_differ = \
            full_width_training(dev, with_nms)
        log("phase 7: full-width training ran through the Trainer")
        train_step_cuda_vs_cpu(dev)
        log("phase 8: CUDA train step agrees with the CPU train step")
        ev = full_width_eval(dev, counters, ckpt)
        log("phase 9: full-width evaluation of phase 7's checkpoint ran")
        eval_exact = eval_cuda_vs_cpu(dev)
        log("phase 10: CUDA evaluation agrees with the CPU evaluation")
        staged = staged_flow(dev, counters)
        log("phase 11: the staged training flow ran at full width")
        stack = stack_full_width(dev, counters)
        log("phase 12: the Stack model ran at full width")
        families_exact = new_families_cuda_vs_cpu(dev)
        log("phase 13: the one-frame and Stack models agree with the CPU")
        variants = variants_full_width(dev, counters)
        log("phase 14: the model variants ran at full width")
        variants_cuda_vs_cpu(dev)
        log("phase 15: the model variants agree with the CPU")
        cli_run = cli_full_width(dev, counters)
        log("phase 16: the CLI and the offline video MOT ran at full width")
        mesh_a = mesh_one_rank(dev, counters)
        log("phase 17(a): the (1, 1) NCCL mesh equals the meshless runs")
        mesh_b = mesh_two_ranks(dev, counters, mesh_a["work"])
        shutil.rmtree(mesh_a["work"], ignore_errors=True)
        log("phase 17(b): two gloo ranks equal one process")
        rest_ops_cuda_vs_cpu(dev)
        log("phase 18: the last ported ops agree with the CPU on the card")
        raster = rasterization_cuda_vs_cpu(dev)
        log("phase 20: the rasterization is bit-equal on the card and the "
            "CPU")
        flagship = flagship_forward_cuda_vs_cpu(dev)
        log("phase 21: the flagship's full-width forward agrees with the "
            "CPU")
        step22 = train_step_full_width_cuda_vs_cpu(dev, counters)
        log("phase 22: the full-width train step agrees with the CPU")
    except PhaseError as exc:
        return fail(str(exc))
    except Exception as exc:                 # a build or launch error
        import traceback
        traceback.print_exc()
        return fail(f"{type(exc).__name__}: {exc}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    for arm in ("static", "ego"):
        print(f"steady keyframe ms ({arm} arm): {times[arm]:.4f} on {card}")
    print(f"pair_latency_ms: {pair_ms:.4f} on {card}")
    print("second stage (pair stage, full width) eager against replayed "
          "from its CUDA graph, medians of 10 calls: " + "; ".join(
              f"{arm} host {t['host_ms']:.4f} ms to issue, {t['ms']:.4f} "
              f"ms to a synchronize" for arm, t in (
                  ("eager", stage["eager"]),
                  ("replayed", stage["replayed"])))
          + f" on {card}")
    print(f"train_step_ms (median, full width, B = 1): {step_ms:.4f}, peak "
          f"device memory {peak_mib:.0f} MiB on {card}")
    print(f"train step gradients twice from one state: {grads_differ} "
          f"leaves differ on {card}")
    b3 = kern["corr_bottleneck"]
    print(f"B3 backward ms through the blur VJP (the route the train step "
          f"takes): {b3['bwd_ms']:.4f}; through the twin's autograd "
          f"{b3['bwd_ms_twin']:.4f}; forward {b3['ms']:.4f}; its gradients' "
          f"largest error with cudnn.allow_tf32 True, relative to max |ref| "
          f"{b3['bwd_rel_err_tf32']:.4g} on {card}")
    st = ev["stages"]
    print(f"eval couples/s (full width, {ev['couples']} couples, "
          f"run_checkpoint_once with val_health): "
          f"{ev['couples'] / ev['wall_s']:.4f}; without val_health "
          f"{ev['couples'] / (ev['wall_s'] - st['val_health']):.4f}; cold "
          f"run {ev['couples'] / ev['cold_wall_s']:.4f} on {card}")
    print("eval seconds: " + ", ".join(
        f"{k} {st[k]:.4f}" for k in ("load", "forward", "write", "ap",
                                     "tracking", "val_health"))
          + f", other {ev['wall_s'] - sum(st.values()):.4f}, wall "
          f"{ev['wall_s']:.4f} on {card}")
    print(f"eval card vs CPU (small config): every box matched within "
          f"2e-3, AP and MOT held equal: {eval_exact}")
    print(f"single-frame forward ms (median of {N_TIMED}, full width, "
          f"B = 1): {staged['forward_ms']:.4f} on {card}")
    st = staged["eval_stages"]
    print(f"detection eval samples/s (full width, {staged['samples']} "
          f"samples, run_checkpoint_once): "
          f"{staged['samples'] / staged['eval_wall_s']:.4f}; cold run "
          f"{staged['samples'] / staged['eval_cold_wall_s']:.4f} on {card}")
    print("detection eval seconds: " + ", ".join(
        f"{k} {st[k]:.4f}" for k in ("load", "forward", "write", "ap"))
          + f", other {staged['eval_wall_s'] - sum(st.values()):.4f}, wall "
          f"{staged['eval_wall_s']:.4f} on {card}")
    print("staged flow step ms: " + "; ".join(
        f"{k} {[round(s, 2) for s in v]}"
        for k, v in staged["step_ms"].items()) + f" on {card}")
    print(f"Stack forward ms (median of {N_TIMED}, full width, B = 1, "
          f"{STACK_FRAMES} frames): {stack['forward_ms']:.4f} on {card}")
    print(f"Stack train step ms ({STACK_TRAIN_STEPS} steps, the first "
          f"included): {[round(s, 2) for s in stack['step_ms']]}, peak "
          f"device memory {stack['peak_mib']:.0f} MiB on {card}")
    print(f"Stack eval stacks/s (full width, {stack['stacks']} stacks, "
          f"with val_health): {stack['stacks'] / stack['eval_wall_s']:.4f} "
          f"on {card}")
    print(f"one-frame and Stack card vs CPU (small config): every detection "
          f"box matched within 2e-3, AP held equal: {families_exact}")
    for name, v in variants.items():
        print(f"variant {name} pair forward ms (median of {N_TIMED}, full "
              f"width, B = 1): {v['forward_ms']:.4f}; train step ms "
              f"{[round(s, 2) for s in v['step_ms']]}, peak device memory "
              f"{v['peak_mib']:.0f} MiB on {card}")
    v2 = variants["V2"]
    print(f"greedy NMS share of V2's forward: {v2['forward_ms']:.4f} ms "
          f"greedy, {v2['exact_nms_forward_ms']:.4f} ms exact, share "
          f"{1 - v2['exact_nms_forward_ms'] / v2['forward_ms']:.4f} on "
          f"{card}")
    inf = cli_run["infer"]
    print(f"cli infer fps_pairs: {inf['fps_pairs']:.4f} (median "
          f"{inf['median_s'] * 1e3:.2f} ms); cli evaluate couples/s "
          f"{cli_run['couples'] / cli_run['eval_s']:.4f} ({cli_run['couples']}"
          f" couples, the command's wall time) on {card}")
    demo = "present, demo ran" if cli_run["matplotlib"] else \
        "absent, demo skipped"
    print(f"cli: matplotlib {demo}; overall MOTA evaluate "
          f"{cli_run['eval_mota']:.4f}, offline iou arm over the frame "
          f"files {cli_run['offline_mota']:.4f}; offline tracks "
          f"{cli_run['tracks']}")
    print(f"mesh (1, 1) over one NCCL rank: Trainer step ms (median of "
          f"steps 2-{MESH_STEPS}, full width, B = 1) {mesh_a['step_ms']:.4f},"
          f" meshless {mesh_a['meshless_step_ms']:.4f}; every Trainer "
          f"step's losses and every state leaf of {MESH_STEPS} steps from "
          f"one state bit-equal to the meshless runs'; no collective runs "
          f"at size 1; bytes all-reduced per step "
          f"{mesh_a['reduced_bytes']} (one data rank; two would all-reduce "
          f"{mesh_a['flat_bytes']}) on {card}")
    for r, rank in enumerate(mesh_b["ranks"]):
        dp, tp = rank["dp_step"], rank["tp_step"]
        print(f"mesh rank {r} of 2 (gloo, one card): (2, 1) step ms "
              f"{dp['ms'][0]:.4f} (one process at B = 2 "
              f"{mesh_b['want']['dp_step']['ms'][0]:.4f}), bytes moved "
              f"{dp['bytes_moved']:.0f}; (1, 2) TP step ms "
              f"{tp['ms'][0]:.4f} (one process "
              f"{mesh_b['want']['tp_step']['ms'][0]:.4f}), bytes moved "
              f"{tp['bytes_moved']:.0f}; TP forward bytes moved "
              f"{rank['tp_forward']['bytes_moved']:.0f}; evaluation s "
              f"{rank['evaluate']['wall_s']:.4f} (one process "
              f"{mesh_b['want']['evaluate']['wall_s']:.4f}); peak device "
              f"memory {rank['peak_mib']:.0f} MiB on {card}")
    print(f"rasterization card vs CPU: bit-equal on bench's points (2 "
          f"frames, 65536 points each, on bench's and on a tilted ground "
          f"plane) and {raster['edge_points']} points "
          f"on cell and slice edges; dividing by the voxel size puts "
          f"{raster['moved_by_division']} edge coordinates in another cell "
          f"on the card than on the CPU")
    for f, fr in enumerate(flagship["frames"]):
        print(f"flagship forward card vs CPU (full width, bf16 towers) frame "
              f"{f}: bev_input bit-equal, top proposals matched "
              f"{fr['top_share']:.4f}, valid finals card {fr['valid_card']} "
              f"CPU {fr['valid_cpu']}, finals matched within 1e-2 "
              f"{fr['final_share_1e-2']:.4f}, within 0.5 "
              f"{fr['final_share_0.5']:.4f}; CPU forward "
              f"{flagship['cpu_forward_s']:.2f} s on {card}")
    print(f"full-width f32 train step card vs CPU (SGD at lr 1): bev_input "
          f"bit-equal, masks and RPN mini-batch exact, loss relative "
          f"differences {step22['loss_rel']}, largest gradient differences "
          f"{step22['worst_grads']}; card step {step22['step_ms']:.4f} ms, "
          f"peak device memory {step22['peak_mib']:.0f} MiB, B3 launches "
          f"{step22['b3_launches']}; CPU step {step22['cpu_step_s']:.2f} s "
          f"on {card}")
    for line in kernel_lines(kern, card):
        print(line)
    for n, r in kern["nms_fixpoint"]["by_n"].items():
        print(f"nms_fixpoint N = {n} ({r['rows']} rows, {r['passes']} "
              f"passes): kernel {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, host {r['host_us']:.1f} us per "
              f"call, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"plain {r['plain_ms']:.4f} ms on {card}")
    # launches in each path's run, and per keyframe (pushes, the first of
    # each arm encoding only), per pair forward and per train step
    launches_by_path = {k.symbol: {
        "stream": launches[k.symbol],
        "per_keyframe": launches[k.symbol] / pushes,
        "pair_forward": fwd_launches[k.symbol],
        "per_pair_forward": fwd_launches[k.symbol] / fwd_calls,
        "train_step": train_launches[k.symbol],
        "per_train_step": train_launches[k.symbol] / TRAIN_STEPS,
        "evaluate_run": ev["launches"][k.symbol],
        "evaluate": ev["launches"][k.symbol] / ev["couples"],
        "evaluate_forwards": ev["forward_launches"][k.symbol],
        "single_frame_forward": staged["forward_launches"][k.symbol],
        "per_single_frame_sample": staged["eval_launches"][k.symbol]
        / staged["samples"],
        "single_frame_train_step": staged["train_launches"]["pretrain"][
            k.symbol] / STAGE_STEPS[0],
        "staged_train_step": staged["train_launches"]["staged"][k.symbol]
        / STAGE_STEPS[1],
        "stack_forward": stack["forward_launches"][k.symbol],
        "per_stack_evaluated": stack["eval_launches"][k.symbol]
        / stack["stacks"],
        **{f"variant_forward_{name}": v["launches"][k.symbol]
           for name, v in variants.items()},
        "per_cli_couple": cli_run["launches"][k.symbol]
        / cli_run["couples"],
        "per_mesh_train_step_1x1": mesh_a["train_launches"][k.symbol]
        / MESH_STEPS,
        # 17(a)'s evaluation forwards one couple n + 1 times
        "per_mesh_evaluated_couple_1x1": mesh_a["eval_launches"][k.symbol]
        / (mesh_a["couples"] + 1),
        **{f"mesh_{name}_per_rank": [r[name]["launches"][k.symbol]
                                     for r in mesh_b["ranks"]]
           for name in ("dp_step", "tp_step")},
        # 17(b)'s ranks forward 2 + n couples between them
        "per_mesh_evaluated_couple_2x1": sum(
            r["evaluate"]["launches"][k.symbol] for r in mesh_b["ranks"])
        / (mesh_b["couples"] + 2),
        "f32_train_step_vs_cpu": step22["launches"][k.symbol]}
        for k in counters}
    launches_by_path[nms._KERNEL.symbol] = {
        "per_keyframe": launches[nms._KERNEL.symbol] / pushes,
        "per_pair_forward": fwd_launches[nms._KERNEL.symbol] / fwd_calls,
        "per_train_step": train_launches[nms._KERNEL.symbol] / TRAIN_STEPS}
    launches_by_path[correlation._CF_KERNEL.symbol] = {
        "correlation_op": op_launches,
        "evaluate": ev["launches"][correlation._CF_KERNEL.symbol]
        / ev["couples"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(k.symbol, op_launches),
         "launches_by_path": launches_by_path[k.symbol],
         **{key: kern[name][key] for key in (
             "max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_device_ms",
             "library_host_us", "bwd_ms", "bwd_ms_twin", "bwd_bound_ms",
             "bwd_bound_by", "bwd_rel_err_tf32", "by_n")
            if key in kern[name]}}
        for name, (src, rep, k) in sources.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
