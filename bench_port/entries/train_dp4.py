"""Entry ``train_dp4``: data-parallel ``Trainer.train`` of the
configuration's model on the mesh ``mix["mesh"]`` (data ranks, 1), one
rank a card over NCCL, the global batch ``batch_size`` split over the
data ranks, the gradients averaged in one flat all-reduce a step.

The ranks start through the port's launcher (``harness/ranks.py``); the
run's own process gives up its copy of the model first, so no copy sits
idle on card 0 in the window. Each rank builds the model, the seed's
weights and the pool itself; the pool's couples are dealt out in
contiguous shares, one per data rank, each taken in turn
(``shard_indices``), through the Trainer's global batches. Every rank
runs the train entry's loop (``entries/train.py``: the same set-up
steps, window and kept steps);
rank 0's clock opens and closes the window for all of them, agreed at
every window step over a gloo group. Rank 0 times the window: the steps
that every rank completed, ``batch_size`` samples each.

Kept for the comparison, as in the train entry: the first steps and
steps of the window drawn from the seed, rank 0's states (every rank
holds the same) and global draws, and each rank's proposals, RPN
mini-batch and two-pass candidates, gathered to rank 0 in rank order.
The comparison runs in rank 0, where the states lie, once the window
has closed and the program's state is freed: the plain reference takes
the ranks' couples of a kept step as one batch, which is the mesh's
global-batch mean (``harness/check.py`` ``train_numbers``). With
``--trace 1`` every rank profiles the same steps; the per-layer metrics
read rank 0's trace and spans, the device's busy and window seconds
are the ranks' means. Each rank reports the modules of JAX or the JAX
package it holds once its work is done; where any rank holds one, the
run gives no result (exit code 2), as ``run.py`` does for its own
process."""
from __future__ import annotations

import functools
import json
import os
import statistics
import sys
from typing import Dict, List

import torch

from harness import check as C
from harness import inputs, ranks
from harness.cells import load_cell, load_entry
from harness.program import Run
from harness.trace import DeviceTrace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROOT_SPAN = "dodt/train_step"
# the ranks' deadline past the window: set-up, the traced steps and the
# comparison in rank 0
DEADLINE_S = 1000.0

train = load_entry(ROOT, "train")


def shard_indices(step: int, data_ranks: int, batch: int, pool: int
                  ) -> List[int]:
    """The pool's couples in step ``step``'s global batch of ``batch``:
    data rank r's rows come from its contiguous share of the pool, in
    turn."""
    local, share = batch // data_ranks, pool // data_ranks
    return [r * share + (step * local + j) % share
            for r in range(data_ranks) for j in range(local)]


class RankShards(inputs.PoolDataset):
    """The Trainer's dataset on every rank: each global batch holds every
    data rank's rows (``shard_indices``); the Trainer keeps its own."""

    def __init__(self, pool: List[Dict], data_ranks: int):
        super().__init__(pool)
        self.data_ranks = data_ranks

    def next_batch(self, batch_size: int, augment: bool = True) -> Dict:
        idx = shard_indices(len(self.served) // batch_size, self.data_ranks,
                            batch_size, len(self.pool))
        self.served.extend(idx)
        return self.batch(self.pool, idx)


class AgreedWrap(train.StepWrap):
    """The train entry's wrapper, with rank 0's clock deciding for every
    rank whether a step is inside the window, so that all ranks close it
    at one step."""

    def __init__(self, inner, ctx, probe, served, group):
        super().__init__(inner, ctx, probe, served)
        self.group = group

    def window_open(self) -> bool:
        import torch.distributed as dist
        flag = torch.tensor([int(super().window_open())], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag[0])


LOCAL = ("proposals", "rpn_mb", "interest")


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x


def _cat(parts, device):
    """The ranks' parts of one field, joined along the batch in rank
    order."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts], device) for k in first}
    if isinstance(first, tuple):
        return tuple(_cat([p[i] for p in parts], device)
                     for i in range(len(first)))
    return torch.cat(parts).to(device)


def rank(cell_name: str, seed: int, seconds: float, traced: bool,
         device_type: str) -> Dict:
    """One rank's run: set-up, the window, the traced steps and, in rank
    0, the comparison."""
    import torch.distributed as dist
    from dodt_tpu_torch.parallel.mesh import make_mesh
    from harness import program
    from harness.weights import make_weights
    from run import Context, forbidden_modules
    r, world = dist.get_rank(), dist.get_world_size()
    if device_type == "cuda":
        device = torch.device("cuda", r)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
    cell = load_cell(ROOT, cell_name)
    ctx = Context(cell, seed, seconds, traced, device)
    mix = ctx.mix
    ctx.program_cfg, model = program.build_model(json.dumps(ctx.pipeline),
                                                 cell.config, cell.family)
    weights = make_weights(
        [(n, p.shape) for n, p in model.named_parameters()], seed, device,
        cell.config["assumed"]["output_scales"])
    ctx.model = program.load(model, weights, device)
    del model
    if r:
        del weights
    mesh = make_mesh(*mix["mesh"])
    group = dist.new_group(backend="gloo")
    wrap = train.train_loop(
        ctx, RankShards(ctx.couples(), mix["mesh"][0]), mesh,
        functools.partial(AgreedWrap, group=group))
    trace = wrap.profiled.result if traced else None
    out = {"rank": r, "calls": wrap.window_steps, "peak": ctx.memory_peak,
           "busy_s": trace.busy_s if trace else None,
           "trace_window_s": trace.window_s if trace else None}
    captures = wrap.start + wrap.sampler.items()
    local = [{k: _cpu(c[k]) for k in LOCAL} for c in captures]
    gathered = [None] * world if r == 0 else None
    dist.gather_object(local, gathered, dst=0, group=group)
    # the program's state goes before the reference runs
    del wrap.inner, ctx.model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if r == 0:
        for i, c in enumerate(captures):
            for k in LOCAL:
                c[k] = _cat([g[i][k] for g in gathered], device)
        flops = [] if traced else None
        notes: List[str] = []
        numbers = C.train_numbers(cell.config, weights, device,
                                  ctx.couples(), captures, flops=flops,
                                  notes=notes, family=cell.family)
        out.update(setup_at=ctx.setup_at, window_s=wrap.t1 - wrap.t0,
                   trace=trace, compared={"numbers": numbers,
                                          "notes": notes, "flops": flops})
    # the other ranks wait for rank 0's comparison before they leave
    dist.barrier(group=group)
    out["forbidden"] = forbidden_modules()
    return out


class RanksTrace(DeviceTrace):
    """Rank 0's traced stretch, with the busy and window seconds of the
    ranks' stretches averaged."""

    def __init__(self, trace: DeviceTrace, busy: List[float],
                 window: List[float]):
        self.__dict__.update(trace.__dict__)
        self.mean_busy_s = statistics.fmean(busy)
        self.window_s = statistics.fmean(window)

    @property
    def busy_s(self) -> float:
        return self.mean_busy_s


def drive(ctx) -> Run:
    mix = ctx.mix
    world = mix["mesh"][0] * mix["mesh"][1]
    cuda = ctx.device.type == "cuda"
    ctx.model = None
    if cuda:
        from dodt_tpu_torch.ops import _cuda
        torch.cuda.empty_cache()
        _cuda.build()         # built once here, before the ranks load it
    out = ranks.spawn(ROOT, "train_dp4", world, ctx.cell.name, ctx.seed,
                      ctx.seconds, ctx.traced, ctx.device.type,
                      backend="nccl" if cuda else "gloo",
                      timeout_s=ctx.seconds + DEADLINE_S)
    found = {o["rank"]: o["forbidden"] for o in out if o["forbidden"]}
    if found:
        print(f"train_dp4: ranks loaded {found}", file=sys.stderr)
        raise SystemExit(2)
    r0 = out[0]
    if any(o["calls"] != r0["calls"] for o in out):
        raise RuntimeError("the ranks' window steps differ: "
                           f"{[o['calls'] for o in out]}")
    ctx.setup_done(at=r0["setup_at"])
    ctx.window_done(peak=max(o["peak"] for o in out))
    run = Run()
    run.samples_per_call = mix["batch_size"]
    run.calls, run.window_s = r0["calls"], r0["window_s"]
    if ctx.traced:
        run.trace = RanksTrace(r0["trace"], [o["busy_s"] for o in out],
                               [o["trace_window_s"] for o in out])
    r0["compared"]["notes"] += [
        f"rank {o['rank']}: device memory peak {o['peak']}" for o in out]
    run.captures = r0["compared"]
    return run


def check(ctx, captures, weights, precision="float32", flops=None,
          notes=None) -> Dict[str, float]:
    """The comparison rank 0 made (``drive``); or, for the control's
    captures (``control``), the train entry's."""
    if isinstance(captures, dict):
        if notes is not None:
            notes.extend(captures["notes"])
        if flops is not None and captures["flops"]:
            flops.extend(captures["flops"])
        return captures["numbers"]
    return train.check(ctx, captures, weights, precision, flops, notes)


def control(ctx, cfg, net, device, rows=None) -> List[Dict]:
    """The train entry's control on the cell's global batch."""
    return train.control(ctx, cfg, net, device, rows)
