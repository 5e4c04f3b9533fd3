"""Entry ``train``: ``Trainer.train`` over the couple pool, in one call.
Its first ``warmup_steps`` steps are set-up; the window opens at the
next step and closes, after ``--seconds``, from a wrapper around the
Trainer's step function, which then ends the loop (after the spans and
the profiled stretch of a traced run). So the state the set-up steps
make is the state the window trains on, through the same loop and feed.

Kept for the comparison: the first ``checked_steps`` steps (the start,
from the weights the seed gave) and ``checked_window_steps`` steps of
the window, drawn from the seed, each with the state before it, the
state after it, its losses, its draws, the proposals the program's
forward chose and the two-pass RPN's candidates in the program's rank
order (read through a spy on the model module's ``top_k``). The
reference follows the start's steps from the seed's weights, and takes
each window step from the program's state before it
(``harness/check.py`` ``train_numbers``)."""
from __future__ import annotations

import contextlib
import shutil
import tempfile
import time
import types
from typing import Dict, List

import torch

from harness import check as C
from harness import inputs
from harness.program import Run, Sampler, spy, sync
from harness.trace import Profiled


class WindowClosed(Exception):
    """Raised from the step wrapper to end Trainer.train."""


class StepWrap:
    """Stands in for the Trainer's ``step_fn``: the set-up steps (the
    first ``checked_steps`` kept), then the window (a reservoir of
    ``checked_window_steps`` kept), then, traced, ``span_steps`` synced
    spans and ``trace_steps`` profiled steps; then it raises
    WindowClosed."""

    def __init__(self, inner, ctx, probe, served):
        self.inner, self.ctx, self.mix = inner, ctx, ctx.mix
        self.sync = sync(ctx.device)
        self.probe, self.served = probe, served
        self.steps = 0                    # every step through the wrapper
        self.start: List[Dict] = []
        self.sampler = Sampler(ctx.mix["checked_window_steps"], ctx.rng)
        self.phase = "setup"
        self.window_steps = 0
        self.t0 = self.t1 = None
        self.spans: List[float] = []
        self.traced_steps = 0
        self.profiled = None
        self.prof = contextlib.ExitStack()

    def kept_step(self, state, batch, rand, kind):
        draws = []

        def recorded(name, shape):
            u = rand(name, shape)
            draws.append((name, u))
            return u
        self.probe["armed"] = True
        try:
            new, losses = self.inner(state, batch, recorded)
        finally:
            self.probe.pop("armed", None)
        bs = self.mix["batch_size"]
        return new, losses, {
            "kind": kind, "step": self.steps, "before": state, "after": new,
            "losses": losses, "draws": draws,
            "couples": self.served[self.steps * bs:(self.steps + 1) * bs],
            "proposals": self.probe.pop("proposals"),
            "rpn_mb": self.probe.pop("rpn_mb"),
            "interest": self.probe.pop("interest", None)}

    def step(self, state, batch, rand):
        mix = self.mix
        if self.phase == "setup":
            if len(self.start) < mix["checked_steps"]:
                new, losses, kept = self.kept_step(state, batch, rand,
                                                   "start")
                self.start.append(kept)
                return new, losses
            if self.steps < mix["warmup_steps"]:
                return self.inner(state, batch, rand)
            self.ctx.setup_done()
            self.phase = "window"
            self.t0 = time.perf_counter()
        if self.phase == "window":
            if self.window_open():
                slot = self.sampler.slot(self.window_steps)
                self.window_steps += 1
                if slot is None:
                    return self.inner(state, batch, rand)
                new, losses, kept = self.kept_step(state, batch, rand,
                                                   "window")
                self.sampler.kept[slot] = kept
                return new, losses
            self.sync()
            self.t1 = time.perf_counter()
            self.ctx.window_done()
            if not self.ctx.traced:
                raise WindowClosed
            self.phase = "spans"
        if self.phase == "spans":
            if len(self.spans) < mix["span_steps"]:
                self.sync()
                ts = time.perf_counter()
                out = self.inner(state, batch, rand)
                self.sync()
                self.spans.append(time.perf_counter() - ts)
                return out
            self.phase = "trace"
            self.profiled = self.prof.enter_context(Profiled(self.sync))
        if self.traced_steps == mix["trace_steps"]:
            self.prof.close()
            raise WindowClosed
        self.traced_steps += 1
        return self.inner(state, batch, rand)

    def window_open(self) -> bool:
        """Whether the next step is inside the window."""
        return time.perf_counter() - self.t0 < self.ctx.seconds

    def __call__(self, state, batch, rand):
        try:
            return self.step(state, batch, rand)
        finally:
            self.steps += 1


def train_loop(ctx, dataset, mesh=None, wrap_class=StepWrap) -> StepWrap:
    """``Trainer.train`` of ``ctx.model`` over ``dataset`` (on ``mesh``,
    where given), its step function wrapped in ``wrap_class``, until the
    wrapper ends the loop; returns the wrapper."""
    from dodt_tpu_torch.models import dt_avod
    from dodt_tpu_torch.runtime.trainer import Trainer
    mix, dev, model, cfg = ctx.mix, ctx.device, ctx.model, ctx.program_cfg
    k_fuse = cfg.model.rpn.fusion_top_k
    probe: Dict = {}
    real_forward = model.forward

    def forward(*a, **k):
        out = real_forward(*a, **k)
        if "armed" in probe:
            probe["proposals"] = (out["top_anchors"].detach(),
                                  out["top_valid"])
            probe["rpn_mb"] = {key: v.detach()
                               for key, v in C.rpn_rows(out).items()}
        return out

    def ranked(real):
        # the two-pass RPN's candidates: the first top_k of fusion_top_k
        # in the armed step's forward
        def top_k(x, k):
            vals, idx = real(x, k)
            if "armed" in probe and k == k_fuse and "interest" not in probe:
                probe["interest"] = idx.detach()
            return vals, idx
        return top_k

    # checkpoints go under TMPDIR; the run ends long before the
    # configuration's checkpoint_interval, so none is written
    ckpt = tempfile.mkdtemp(prefix="bench_port_ckpt_")
    model.train()
    model.forward = forward
    wrap = None
    try:
        trainer = Trainer(cfg, model, dataset, ckpt, mesh=mesh,
                          batch_size=mix["batch_size"], device=dev)
        wrap = wrap_class(trainer.step_fn, ctx, probe, dataset.served)
        trainer.step_fn = wrap
        with spy(dt_avod, "top_k", ranked):
            try:
                trainer.train(max_steps=10 ** 9, log_every=mix["log_every"])
            except WindowClosed:
                pass
    finally:
        if wrap is not None:
            wrap.prof.close()
        model.__dict__.pop("forward", None)
        shutil.rmtree(ckpt, ignore_errors=True)
    return wrap


def drive(ctx) -> Run:
    wrap = train_loop(ctx, inputs.PoolDataset(ctx.couples()))
    run = Run()
    run.samples_per_call = ctx.mix["batch_size"]
    run.calls = wrap.window_steps
    run.window_s = wrap.t1 - wrap.t0
    if ctx.traced:
        run.spans = {"step_fn": wrap.spans}
        run.trace = wrap.profiled.result
    run.captures = wrap.start + wrap.sampler.items()
    return run


def check(ctx, captures, weights, precision="float32", flops=None,
          notes=None) -> Dict[str, float]:
    return C.train_numbers(ctx.config, weights, ctx.device, ctx.couples(),
                           captures, precision, flops, notes,
                           ctx.cell.family)


def control(ctx, cfg, net, device, rows=None) -> List[Dict]:
    """The reference ``net``'s own steps from the seed's weights: the
    start's ``checked_steps``, then ``checked_window_steps`` more, kept as
    window steps, on the pool's couples in turn with draws from a
    generator of its own.

    With ``rows``, a fault of a data-parallel step: each step's update
    and losses come from the first ``rows`` rows of its batch alone, with
    those rows of the batch's draws, while the whole batch's forward
    gives the draws, proposals and candidates kept (half of the batch
    left out; the exchange between the ranks left out, rank 0's rows)."""
    from reference import model as ref_model
    from reference import optim as ref_optim
    mix = ctx.mix
    couples = ctx.couples()
    bs = mix["batch_size"]
    params = {n: p.detach().clone() for n, p in net.named_parameters()}
    opt = ref_optim.adam_init(params)
    out = []
    for step in range(mix["checked_steps"] + mix["checked_window_steps"]):
        draws = []
        gen = ref_model.generator_draws(
            torch.Generator(device).manual_seed((42 << 32) + step))

        def rand(name, shape, gen=gen, draws=draws):
            u = gen(name, shape)
            draws.append((name, u))
            return u
        idx = [(step * bs + j) % len(couples) for j in range(bs)]
        before = types.SimpleNamespace(params=params, opt_state=opt)
        batch = C.on(inputs.PoolDataset.batch(couples, idx), device)
        new, new_opt, losses, _, fwd = ref_optim.train_step(
            cfg, net, params, opt, batch, rand)
        if rows is not None:
            whole = C.replay(draws)

            def part(name, shape, whole=whole):
                return whole(name, (shape[0] * bs // rows,)
                             + tuple(shape[1:]))[:shape[0]]
            new, new_opt, losses, _, _ = ref_optim.train_step(
                cfg, net, params, opt,
                {k: v[:rows] for k, v in batch.items()}, part)
        params, opt = new, new_opt
        out.append({"kind": ("start" if step < mix["checked_steps"]
                             else "window"),
                    "step": step, "before": before, "losses": losses,
                    "draws": draws, "couples": idx,
                    "proposals": (fwd["top_anchors"], fwd["top_valid"]),
                    "rpn_mb": C.rpn_rows(fwd),
                    "interest": (fwd["interest"].flatten(0, 1)
                                 if "interest" in fwd else None),
                    "after": types.SimpleNamespace(params=params,
                                                   opt_state=opt)})
    return out
