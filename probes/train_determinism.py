"""Is the port's full-width train step reproducible on the card, and which
ops keep it from being so (ROADMAP C19)?

    python3 probes/train_determinism.py

From chip_smoke.py's phase 7 set-up (cars_dt_tracking at 65536 points,
smoke_model's seeded weights, SmokeStream's first couple, draws from a
seeded generator), on one card, TF32 off:
  1. every parameter's gradient, twice from one state with the same
     draws: which leaves differ, by how much (max |diff|, that over the
     leaf's largest |gradient|) and in how many elements; then
     make_train_step twice from one state: the losses, and the params,
     Adam's mu and nu and the EMA leaves that differ;
  2. the gradients twice with torch.backends.cudnn.deterministic alone
     (cuDNN's deterministic algorithms, nothing else), and the step's
     time so; then the same under torch.use_deterministic_algorithms(True,
     warn_only=True): the ops that warn (each of them raises under
     use_deterministic_algorithms(True)), and the gradients twice again;
  3. one step under use_deterministic_algorithms(True) and autograd's
     anomaly mode: the error raised first, and the forward call that made
     the backward op that raised;
  4. the step's median time over N_TIMED steps with deterministic
     algorithms off, with cuDNN's alone (part 2) and all on (warn_only),
     and off with B3's backward
     through the twin's autograd instead of corr_bottleneck_vjp (the
     port's backward before it; swapped in by this probe only);
  5. two backwards alone, each run twice, with deterministic algorithms
     off and on, in f32 and bf16: the largest difference between the two
     runs. ``crop``: the BEV crop (crop_and_resize_gather's advanced
     indexing; its backward is an index_put_ with accumulate) on a (350,
     400, 32) map with chip_smoke's 300 boxes. ``take``: the RPN's
     torch.gather of the fused candidates' rows from every anchor's BEV
     ROI (models/dt_avod.py ``_take(bev_flat, interest, 1)``; its
     backward is a scatter_add), (1, 89600, 9) rows by the top 8192 and
     a 512-row mini-batch of which half repeat top-k rows;
  6. where the gradients part: the gradients twice with every call of
     TAPPED (models/dt_avod.py's functions and bottleneck modules)
     tapped, its inputs and its output each through an identity autograd
     node that keeps the gradient flowing through it: the calls whose
     output gradient is bit-equal in both runs and an input gradient is
     not (the op that parts them), and the first calls, in backward
     order, whose output gradients differ.
The process sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts
(cuBLAS refuses deterministic mode without it), in every part.

Prints one JSON line."""
import json
import os
import sys
import time
import traceback
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

N_TIMED = 5
# models/dt_avod.py functions and DtAvodNet submodules tapped in part 6
TAPPED = ("tower_forward", "bev_anchor_rois", "dense_bev_rois", "_take",
          "crop_and_resize", "corr_bottleneck", "_resize_to",
          "feature_fuse", "dropout")
TAPPED_MODULES = ("bev_bottleneck", "img_bottleneck", "bev_corr_bottleneck")


class _Tap(torch.autograd.Function):
    """Identity whose backward keeps a copy of the gradient in ``slot``."""

    @staticmethod
    def forward(ctx, x, slot):
        ctx.slot = slot
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        ctx.slot.append(grad.detach().clone())
        return grad, None


def tapped(name, fn, calls):
    """fn with its grad-requiring tensor arguments and its output tapped;
    each call appends {"name", "ins": [slot, ...], "out": slot} to
    ``calls``."""
    def call(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        rec = {"name": name, "ins": [], "out": [], "shapes": []}
        new = []
        for a in args:
            if torch.is_tensor(a) and a.requires_grad:
                rec["ins"].append([])
                rec["shapes"].append(tuple(a.shape))
                a = _Tap.apply(a, rec["ins"][-1])
            new.append(a)
        out = fn(*new, **kw)
        if torch.is_tensor(out) and out.requires_grad:
            out = _Tap.apply(out, rec["out"])
            calls.append(rec)
        return out
    return call


def first_diff(slots_a, slots_b):
    """max |a - b| of two taps' summed gradients (None where none came)."""
    if not slots_a or not slots_b:
        return None
    return float((sum(slots_a).float() - sum(slots_b).float()).abs().max())


def leaf_diffs(a, b):
    """Leaves of two {name: tensor} dicts that differ: [name, max |diff|,
    that over max |b|, differing elements, elements], largest share
    first."""
    rows = []
    for k, v in b.items():
        d = (a[k].float() - v.float()).abs()
        top = float(d.max())
        if top > 0:
            scale = float(v.float().abs().max())
            rows.append([k, top, top / scale if scale else float("inf"),
                         int((d > 0).sum()), v.numel()])
    return sorted(rows, key=lambda r: -r[2])


def state_leaves(state):
    out = {f"params {k}": v for k, v in state.params.items()}
    for part in ("mu", "nu"):
        out.update({f"{part} {k}": v for k, v in
                    state.opt_state.get(part, {}).items()})
    out.update({f"ema {k}": v for k, v in
                (state.ema_params or {}).items()})
    return out


def main():
    if not torch.cuda.is_available():
        print("train_determinism: no CUDA card", file=sys.stderr)
        return 1
    from dodt_tpu_torch.models.dt_avod import generator_draws
    from dodt_tpu_torch.ops import correlation as corr
    from dodt_tpu_torch.runtime.trainer import (SEED, create_train_state,
                                                make_train_step,
                                                model_losses)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.mesh_cfg()
    model = chip_smoke.smoke_model(cfg).to(dev).train()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             chip_smoke.SmokeStream(cfg, 7).next_batch(1).items()}
    loss_fn = model_losses(model)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model)

    def draws():
        g = torch.Generator(dev)
        g.manual_seed(SEED << 32)
        return generator_draws(g)

    def grads():
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        rand = draws()
        out = torch.func.functional_call(
            model, params, (batch,),
            {"mode": "train", "train": True, "rand": rand})
        total, _ = loss_fn(cfg, out, batch, rand)
        gs = torch.autograd.grad(total, list(params.values()),
                                 allow_unused=True)
        return {k: g for k, g in zip(params, gs) if g is not None}

    def median_step_ms():
        times = []
        for _ in range(N_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, draws())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    res = {"card": torch.cuda.get_device_name(0)}
    step(state, batch, draws())                    # set-up, untimed
    g1, g2 = grads(), grads()
    res["grads_differ"] = leaf_diffs(g1, g2)
    res["grads_compared"] = len(g2)
    (s1, l1), (s2, l2) = (step(state, batch, draws()) for _ in range(2))
    res["losses_equal"] = all(float(l1[k]) == float(l2[k]) for k in l1)
    res["state_differs"] = leaf_diffs(state_leaves(s1), state_leaves(s2))
    del g1, g2, s1, s2
    res["step_ms"] = median_step_ms()

    vjp = corr.corr_bottleneck_vjp
    corr.corr_bottleneck_vjp = chip_smoke.twin_vjp
    try:
        res["step_ms_twin_backward"] = median_step_ms()
    finally:
        corr.corr_bottleneck_vjp = vjp

    torch.backends.cudnn.deterministic = True
    try:
        g1, g2 = grads(), grads()
        res["cudnn_deterministic_grads_differ"] = leaf_diffs(g1, g2)
        del g1, g2
        res["step_ms_cudnn_deterministic"] = median_step_ms()
    finally:
        torch.backends.cudnn.deterministic = False

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g1, g2 = grads(), grads()
        res["deterministic_warnings"] = sorted(
            {str(w.message).splitlines()[0] for w in caught
             if "deterministic" in str(w.message)})
        res["deterministic_grads_differ"] = leaf_diffs(g1, g2)
        del g1, g2
        res["step_ms_deterministic"] = median_step_ms()
    finally:
        torch.use_deterministic_algorithms(False)

    torch.use_deterministic_algorithms(True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                torch.autograd.detect_anomaly(check_nan=False):
            warnings.simplefilter("always")
            grads()
        res["deterministic_error"] = None
    except RuntimeError as exc:
        frames = [f"{os.path.relpath(fr.filename)}:{fr.lineno} {fr.name}"
                  for fr in traceback.extract_tb(exc.__traceback__)
                  if "dodt_tpu_torch" in fr.filename]
        forward = [str(w.message) for w in caught
                   if "Traceback of forward call" in str(w.message)]
        res["deterministic_error"] = {
            "error": str(exc).splitlines()[0], "frames": frames[-4:],
            "forward_of_backward_op": [
                ln.strip() for ln in "\n".join(forward).splitlines()
                if "dodt_tpu_torch" in ln][-4:]}
    finally:
        torch.use_deterministic_algorithms(False)

    from dodt_tpu_torch.models.dt_avod import _take
    from dodt_tpu_torch.ops import roi
    g = torch.Generator().manual_seed(3)
    maps, boxes = chip_smoke.bev_crop_inputs(g, 1, dev)
    rows = torch.randn((1, 89600, 9), generator=g).to(dev)
    top = torch.randperm(89600, generator=g)[:8192]
    mb = torch.cat([top[torch.randperm(8192, generator=g)[:256]],
                    torch.randperm(89600, generator=g)[:256]])
    interest = torch.cat([top, mb])[None].to(dev)
    calls = {
        "crop": (maps[0], lambda x: roi.crop_and_resize_gather(
            x, boxes[0], 7)),
        "take": (rows, lambda x: _take(x, interest, 1))}
    res["backward_differs"] = {}
    for mode in ("off", "on"):
        torch.use_deterministic_algorithms(mode == "on")
        try:
            for name, (x0, fn) in calls.items():
                for dtype in (torch.float32, torch.bfloat16):
                    x = x0.to(dtype).requires_grad_()
                    out = fn(x)
                    cot = torch.randn(out.shape, generator=torch.Generator(
                        ).manual_seed(5)).to(dev, dtype)
                    gs = [torch.autograd.grad(fn(x), x, cot)[0].float()
                          for _ in range(2)]
                    key = f"{name}, deterministic {mode}, {str(dtype)[6:]}"
                    res["backward_differs"][key] = float(
                        (gs[0] - gs[1]).abs().max())
        finally:
            torch.use_deterministic_algorithms(False)

    from dodt_tpu_torch.models import dt_avod
    saved = {n: getattr(dt_avod, n) for n in TAPPED}
    runs = []
    try:
        for _ in range(2):
            calls = []
            for n in TAPPED:
                setattr(dt_avod, n, tapped(n, saved[n], calls))
            for n in TAPPED_MODULES:
                mod = getattr(model, n, None)
                if mod is not None:
                    mod.forward = tapped(n, type(mod).forward.__get__(mod),
                                         calls)
            grads()
            runs.append(calls)
    finally:
        for n, fn in saved.items():
            setattr(dt_avod, n, fn)
        for n in TAPPED_MODULES:
            if getattr(model, n, None) is not None:
                del getattr(model, n).forward
    parts, differ = [], []
    for i, (ra, rb) in enumerate(zip(*runs)):
        d_out = first_diff(ra["out"], rb["out"])
        d_in = [first_diff(x, y) for x, y in zip(ra["ins"], rb["ins"])]
        row = [i, ra["name"], ra["shapes"], d_out, d_in]
        if d_out == 0 and any(d for d in d_in if d):
            parts.append(row)
        if d_out:
            differ.append(row)
    res["tapped_calls"] = [len(r) for r in runs]
    res["parts_here"] = parts
    res["output_grads_differ"] = differ[-6:]

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
