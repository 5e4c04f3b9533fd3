"""Ranks of one process group in fresh processes, and the rank programs
that the multi-rank dry run (``entry.dryrun_multichip``), ``chip_smoke.py``
and the tests start.

``spawn(fn, n, *args)`` runs ``fn(*args)`` in ``n`` processes started
with the ``spawn`` method. Each joins one process group through a
rendezvous file in a directory of its own (no TCP port, so concurrent
runs cannot collide), runs one CPU thread, and hands its result back
through a file; the parent waits until a deadline, stops every child
when one fails or the deadline passes, and raises with the failing
rank's traceback. A child imports this package and torch, nothing of
the caller's test or script modules unless ``fn`` lives there.

The programs (``train_steps``, ``forward``, ``trainer_run``,
``evaluate``) run the port's entry points on a mesh of the given shape,
or meshless for ``mesh_shape=None``, so one function gives both sides of
a comparison. Like the entry points, they run on the card unless the
caller asks for the CPU (``device="cpu"``). Each returns full (gathered)
CPU tensors or numpy arrays.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dodt_tpu_torch.models.dt_avod import generator_draws, table_draws
from dodt_tpu_torch.parallel import mesh as mesh_lib
from dodt_tpu_torch.runtime import trainer as trainer_lib
from dodt_tpu_torch.runtime.evaluator import Evaluator


def _rank_main(rank: int, world: int, backend: str, out_dir: str,
               timeout_s: float):
    torch.set_num_threads(1)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    init_file = os.path.join(out_dir, "rendezvous")
    try:
        # the parent's own file (spawn below)
        fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                              weights_only=False)
        if backend == "nccl":
            torch.cuda.set_device(rank)      # one card per rank
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          timeout_s: float = 300.0) -> List[Any]:
    """``fn(*args)`` on ranks 0..world-1 of one fresh process group;
    returns each rank's result in rank order. ``fn`` and ``args`` are
    pickled (``fn`` by its import path). Under NCCL rank r runs on card
    r. Raises RuntimeError, after every child has stopped, when a rank
    fails or ``timeout_s`` passes."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        # the call goes through a file: a child reads its start-up pipe
        # only as it imports, so large arguments there would start the
        # ranks one after another
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, tmp, timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        late = False
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            late = time.monotonic() > deadline
            if late:
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            when = f" (stopped at the {timeout_s:.0f} s deadline)" if late \
                else ""
            raise RuntimeError(f"spawned ranks of {fn.__qualname__} "
                               f"failed{when}:\n" + "\n".join(errors))
        # the ranks' own files, written by this program's children
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# Rank programs


def sequence(calls: Sequence[Tuple[Callable, tuple]]) -> List[Any]:
    """Each ``(fn, args)`` of ``calls`` in turn on this rank, their
    results in order: several programs in one spawn."""
    return [fn(*args) for fn, args in calls]


def _mesh(mesh_shape: Optional[Tuple[int, int]]):
    return None if mesh_shape is None else mesh_lib.make_mesh(*mesh_shape)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tensors(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _peak_mib(dev) -> Optional[float]:
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 20
            if dev.type == "cuda" else None)


def train_steps(cfg, model: torch.nn.Module,
                batches: Sequence[Dict[str, np.ndarray]],
                draws: Optional[Sequence[Dict[str, np.ndarray]]] = None,
                mesh_shape: Optional[Tuple[int, int]] = None,
                device="cuda") -> Dict[str, Any]:
    """``make_train_step`` from the model's parameters, one step per
    global batch, with ``draws[i]`` (a name -> global draw table, as
    ``table_draws`` reads) or, for None, the Trainer's generator of step
    i. Returns the losses per step, the final state gathered to full CPU
    tensors, ms per step (host clock, synchronised), the bytes the last
    step's gradient all-reduce carried, the mesh's bytes moved per step
    and the peak device memory."""
    dev = torch.device(device)
    model = model.to(dev)
    mesh = _mesh(mesh_shape)
    step = trainer_lib.make_train_step(cfg, model, mesh)
    state = trainer_lib.create_train_state(cfg, model)
    if mesh is not None:
        state = mesh_lib.shard_train_state(state, mesh)
        moved0 = mesh.bytes_moved
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for i, batch in enumerate(batches):
        if mesh is not None:
            batch = mesh_lib.shard_batch(batch, mesh)
        batch = _tensors(batch, dev)
        if draws is not None:
            rand = table_draws(draws[i], dev)
        else:
            g = torch.Generator(dev)
            g.manual_seed((trainer_lib.SEED << 32) + i)
            rand = generator_draws(g)
        _sync(dev)
        t0 = time.perf_counter()
        state, out = step(state, batch, rand)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    if mesh is not None:
        moved = (mesh.bytes_moved - moved0) / len(batches)
        state = mesh_lib.gather_train_state(state, mesh, step.sharded)
    return {"losses": losses, "state": _cpu(state.__dict__), "ms": ms,
            "reduced_bytes": step.reduced_bytes,
            "bytes_moved": moved if mesh is not None else 0,
            "sharded": step.sharded, "peak_mib": _peak_mib(dev)}


def forward(cfg, model: torch.nn.Module, batch: Dict[str, np.ndarray],
            keys: Sequence[str], mesh_shape: Optional[Tuple[int, int]] = None,
            device="cuda") -> Dict[str, Any]:
    """The val-mode forward of a global batch through
    ``torch.func.functional_call`` with the parameters laid out over the
    mesh (the FC trunks sharded over 'model', this rank's rows of the
    batch); ``keys`` of the outputs gathered over the data ranks, as
    numpy, with the mesh's bytes moved and the sharded leaves."""
    dev = torch.device(device)
    model = model.to(dev).eval()
    mesh = _mesh(mesh_shape)
    params = {k: v.detach() for k, v in model.named_parameters()}
    sharded = {}
    if mesh is not None:
        sharded = mesh_lib.shard_module(model, mesh)
        params = mesh_lib.shard_params(mesh_lib.replicated(params, mesh),
                                       mesh, sharded)
        batch = mesh_lib.shard_batch(batch, mesh)
    with torch.no_grad():
        out = torch.func.functional_call(model, params, (_tensors(batch,
                                                                  dev),),
                                         {"mode": "val"})
    out = {k: out[k] for k in keys}
    if mesh is not None:
        out = {k: mesh_lib.all_gather_cat(v, mesh.data_group, mesh)
               for k, v in out.items()}
    return {"outputs": {k: v.cpu().numpy() for k, v in out.items()},
            "bytes_moved": mesh.bytes_moved if mesh is not None else 0,
            "sharded": sharded}


def trainer_run(cfg, model: torch.nn.Module, dataset, ckpt_dir: str,
                steps: int, batch_size: int,
                mesh_shape: Optional[Tuple[int, int]] = None,
                device="cuda") -> Dict[str, Any]:
    """``Trainer.train`` for ``steps`` steps (the checkpoint directory's
    latest checkpoint resumes); the history (wall time dropped) and the
    final state gathered to full CPU tensors."""
    mesh = _mesh(mesh_shape)
    tr = trainer_lib.Trainer(cfg, model, dataset, ckpt_dir, mesh=mesh,
                 batch_size=batch_size, metrics_path=None, device=device)
    state, hist = tr.train(max_steps=steps, log_every=1, prefetch=0)
    if mesh is not None:
        state = mesh_lib.gather_train_state(state, mesh, tr.step_fn.sharded)
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in hist],
            "state": _cpu(state.__dict__)}


def evaluate(cfg, model: torch.nn.Module, dataset, ckpt_dir: str,
             output_dir: str, idxs: Sequence[int], step: int,
             mesh_shape: Optional[Tuple[int, int]] = None,
             device="cuda") -> Dict[str, Any]:
    """``Evaluator.predict_couples(idxs)`` with the checkpoint's params
    (the detections and couples per index) and
    ``run_checkpoint_once(step)`` (its results); on a mesh only global
    rank 0 writes ``output_dir``."""
    ev = Evaluator(cfg, model, dataset, ckpt_dir, output_dir,
                   mesh=_mesh(mesh_shape), device=device)
    ev.model.load_state_dict(
        trainer_lib.CheckpointIO(ckpt_dir).restore_params(step))
    preds = [{"dets": r["dets"], "couple": r["couple"]}
             for r in ev.predict_couples(list(idxs))]
    t0 = time.perf_counter()
    results = ev.run_checkpoint_once(step)
    return {"predictions": preds, "results": results,
            "wall_s": time.perf_counter() - t0,
            "peak_mib": _peak_mib(ev.device)}
