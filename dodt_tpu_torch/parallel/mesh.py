"""The ('data', 'model') mesh over torch.distributed (PyTorch port of
dodt_tpu/parallel/mesh.py).

JAX runs one controller over a device ``Mesh`` and lets XLA insert the
collectives. PyTorch runs one process per rank, so the ``Trainer`` and the
``Evaluator`` run in every rank over an initialised process group, and the
collectives are explicit calls on plain tensors:

  * 'data': the couple axis is split over the data ranks (``shard_batch``);
    each rank draws the global-shaped uniforms and keeps its rows
    (``shard_draws``), so dropout, path drop and sampling equal the
    meshless run's; the gradients (and the losses) are summed over the
    data group in one flat all-reduce and divided by its size
    (``reduce_over_data``), which gives the global batch mean.
  * 'model': tensor parallelism of the wide FC trunks. The rule is JAX's
    (``param_shardings``); a sharded ``Dense`` holds its rows (output
    columns) of the weight, computes those columns and gathers them over
    the model group (``column_linear``), so dropout sees the full
    activation. Biases stay replicated, as JAX shards only kernels. The
    replicated leaves' gradients are averaged over the model group
    (``mean_over_model``), so every model rank applies one update to them.

Rank r sits at (r // num_model, r % num_model), JAX's
``devices.reshape(num_data, num_model)``. The process group is the
caller's: ``make_mesh`` raises without one, and nothing here falls back
to a single rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# FC trunks whose weights get tensor-parallel sharding on 'model'
_TP_SUBTREES = ("avod_fc", "corr_fc", "rpn_cls", "rpn_reg")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on the (data, model) grid and its two groups:
    the ranks that share its model index (``data_group``, over which the
    gradients are reduced) and those that share its data index
    (``model_group``, over which TP layers gather). ``bytes_moved``
    counts the bytes of every collective's result on this rank (the
    gradient all-reduces, the TP gathers and their backward all-reduces,
    the checkpoint gathers)."""
    shape: Dict[str, int]
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    bytes_moved: int = 0

    @property
    def num_data(self) -> int:
        return self.shape["data"]

    @property
    def num_model(self) -> int:
        return self.shape["model"]


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """A ('data', 'model') mesh over every rank of the initialised
    default process group; a collective call, made by every rank."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (torchrun, or "
                           "dodt_tpu_torch.parallel.launch.spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_data is None:
        num_data = world // num_model
    if num_data < 1 or num_model < 1 or num_data * num_model != world:
        raise ValueError(f"mesh ({num_data}, {num_model}) does not cover "
                         f"the {world} ranks")
    # new_group is collective: every rank makes every group, in one order
    data_groups = [dist.new_group([d * num_model + m
                                   for d in range(num_data)])
                   for m in range(num_model)]
    model_groups = [dist.new_group([d * num_model + m
                                    for m in range(num_model)])
                    for d in range(num_data)]
    d, m = divmod(rank, num_model)
    return Mesh({"data": num_data, "model": num_model}, d, m,
                data_groups[m], model_groups[d])


# ---------------------------------------------------------------------------
# Batches and draws (the 'data' axis)


def batch_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of a ``rows``-long couple axis: the data index's
    contiguous block. The axis must divide evenly, as JAX's sharding
    requires."""
    if rows % mesh.num_data:
        raise ValueError(f"{rows} couples do not split over "
                         f"{mesh.num_data} data ranks")
    k = rows // mesh.num_data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array (numpy or torch) of a global
    batch; other entries pass through."""
    return {k: v[batch_sharding(mesh, len(v))]
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
            for k, v in batch.items()}


def shard_draws(rand: Callable, mesh: Mesh) -> Callable:
    """``rand`` for this rank's rows: each call draws the global shape
    (the leading axis, batch-major, times num_data) and keeps the rank's
    block, so every rank's draws are the meshless run's rows."""
    if mesh.num_data == 1:
        return rand

    def local(name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        u = rand(name, (shape[0] * mesh.num_data,) + tuple(shape[1:]))
        return u[batch_sharding(mesh, u.shape[0])]
    return local


# ---------------------------------------------------------------------------
# Collectives


def all_gather_cat(x: torch.Tensor, group, mesh: Mesh, dim: int = 0
                   ) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim``, in
    rank order (a list all_gather, which every supported torch has)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    mesh.bytes_moved += n * x.numel() * x.element_size()
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place."""
    dist.all_reduce(x, group=group)
    mesh.bytes_moved += x.numel() * x.element_size()
    return x


def replicated(tree, mesh: Mesh):
    """Every tensor of ``tree`` (a tensor or a dict of them, nested) set
    to global rank 0's values on every rank (one broadcast per tensor):
    the replicated layout, whatever each rank started from."""
    if isinstance(tree, dict):
        return {k: replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and dist.get_world_size() > 1:
        tree = tree.detach().clone().contiguous()
        dist.broadcast(tree, 0)
    return tree


def _mean(tensors: List[torch.Tensor], group, n: int, mesh: Mesh
          ) -> Tuple[List[torch.Tensor], int]:
    """``tensors`` averaged over ``group`` (``n`` ranks) in one flat f32
    all-reduce; returns them and the bytes all-reduced."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    all_reduce(flat, group, mesh)
    flat /= n
    return ([p.view_as(t).to(t.dtype)
             for p, t in zip(flat.split([t.numel() for t in tensors]),
                             tensors)],
            flat.numel() * flat.element_size())


def reduce_over_data(grads: Dict[str, torch.Tensor],
                     losses: Dict[str, torch.Tensor], mesh: Mesh):
    """(grads, losses) averaged over the data group: one flat all-reduce
    of every gradient and loss, divided by num_data. Each rank's losses
    are means over its rows, so the result is the global batch mean's,
    JAX's semantics. Returns (grads, losses, bytes all-reduced)."""
    if mesh.num_data == 1:
        return grads, losses, 0
    out, nbytes = _mean(list(grads.values()) + list(losses.values()),
                        mesh.data_group, mesh.num_data, mesh)
    n = len(grads)
    return dict(zip(grads, out[:n])), dict(zip(losses, out[n:])), nbytes


def mean_over_model(grads: Dict[str, torch.Tensor],
                    sharded: Dict[str, bool], mesh: Mesh):
    """The replicated leaves' gradients averaged over the model group, in
    one flat all-reduce. Every model rank computes them from the same
    gathered activations, but the card's backward sums some of them with
    atomics, so the ranks' copies can part in the last bits; the average
    gives every rank the same gradient, so the replicated leaves, their
    moments and their EMA stay identical over the model group, as JAX's
    one logical array is. Returns (grads, bytes all-reduced)."""
    names = [k for k in grads if not sharded[k]]
    if mesh.num_model == 1 or not names:
        return grads, 0
    out, nbytes = _mean([grads[k] for k in names], mesh.model_group,
                        mesh.num_model, mesh)
    return {**grads, **dict(zip(names, out))}, nbytes


def sum_over_shards(values: Sequence[torch.Tensor], sharded: Sequence[bool],
                    mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Per-leaf scalars (sums over a leaf) with each sharded leaf's summed
    over the model group, so every leaf counts once in full: what the
    global-norm clip needs. One all-reduce for all the sharded leaves."""
    idx = [i for i, s in enumerate(sharded) if s]
    if mesh is None or mesh.num_model == 1 or not idx:
        return list(values)
    part = all_reduce(torch.stack([values[i] for i in idx]),
                      mesh.model_group, mesh)
    out = list(values)
    for j, i in enumerate(idx):
        out[i] = part[j]
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism (the 'model' axis)


def param_shardings(params: Dict[str, torch.Tensor], mesh: Mesh
                    ) -> Dict[str, bool]:
    """True for the leaves sharded over 'model', JAX's rule: the 2-D
    weights under the FC trunks whose output dimension divides by the
    model axis. Flax kernels are (in, out), the port's Dense weights
    (out, in), so the rule reads dim 0; a sharded weight keeps its rank's
    block of rows. Everything else (biases included) is replicated."""
    def rule(name: str, leaf: torch.Tensor) -> bool:
        keys = name.split(".")
        return (any(k in _TP_SUBTREES for k in keys[:-1])
                and keys[-1] == "weight" and leaf.ndim == 2
                and leaf.shape[0] % mesh.num_model == 0)
    return {k: rule(k, v) for k, v in params.items()}


def _rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    k = t.shape[0] // mesh.num_model
    return t[mesh.model_index * k:(mesh.model_index + 1) * k].clone()


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 sharded: Optional[Dict[str, bool]] = None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's block of every sharded leaf; the rest as they are."""
    sharded = sharded or param_shardings(params, mesh)
    if mesh.num_model == 1:
        return dict(params)
    return {k: _rows(v, mesh) if sharded[k] else v for k, v in params.items()}


def gather_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                  sharded: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """Full tensors from this rank's blocks: the sharded leaves gathered
    over the model group (a collective call, made by every rank)."""
    if mesh.num_model == 1:
        return dict(params)
    return {k: all_gather_cat(v, mesh.model_group, mesh) if sharded[k]
            else v for k, v in params.items()}


def _map_state(state, fn):
    """``state`` (a trainer.TrainState) with ``fn`` applied to its params,
    to every params-keyed dict of its optimiser state (Adam's mu and nu,
    momentum's trace, rmsprop's nu) and to its EMA params."""
    keys = state.params.keys()
    opt = {k: fn(v) if isinstance(v, dict) and v.keys() == keys else v
           for k, v in state.opt_state.items()}
    ema = None if state.ema_params is None else fn(state.ema_params)
    return state._replace(params=fn(state.params), opt_state=opt,
                          ema_params=ema)


def shard_train_state(state, mesh: Mesh):
    """A full TrainState laid out over the mesh: params, the optimiser's
    params-shaped moments and the EMA shadow keep this rank's block of
    each sharded leaf (mesh.py:69-111 of the JAX package); the step and
    schedule counts are replicated. Every tensor is global rank 0's
    (``replicated``) before it is cut, so the ranks start alike."""
    sharded = param_shardings(state.params, mesh)
    return _map_state(state, lambda t: shard_params(replicated(t, mesh),
                                                    mesh, sharded))


def gather_train_state(state, mesh: Mesh, sharded: Dict[str, bool]):
    """The full TrainState back from its shards, on every rank (what a
    checkpoint holds)."""
    return _map_state(state, lambda t: gather_params(t, mesh, sharded))


def shard_module(model: torch.nn.Module, mesh: Mesh) -> Dict[str, bool]:
    """Let every sharded ``Dense`` of ``model`` take its block of rows:
    each gets the mesh as ``tp``. Returns the rule's map."""
    params = dict(model.named_parameters())
    sharded = param_shardings(params, mesh)
    if mesh.num_model > 1:
        for name, is_sharded in sharded.items():
            if is_sharded:
                model.get_submodule(name.rsplit(".", 1)[0]).tp = mesh
    return sharded


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (each
    model rank holds the part of it its own columns give)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh.model_group,
                          ctx.mesh), None


class _GatherColumns(torch.autograd.Function):
    """This rank's output columns gathered over the model group along the
    last axis; the gradient keeps this rank's columns (every model rank
    computes the same downstream from the same gathered activation)."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.index, ctx.cols = mesh.model_index, y.shape[-1]
        return all_gather_cat(y, mesh.model_group, mesh, dim=-1)

    @staticmethod
    def backward(ctx, g):
        c = ctx.cols
        return g[..., ctx.index * c:(ctx.index + 1) * c], None


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """``F.linear(x, full weight, bias)`` from this rank's rows of the
    weight: the rank's columns (its slice of the replicated bias
    included), then gathered over the model group."""
    k = weight.shape[0]
    x = _ToModel.apply(x, mesh)
    b = _ToModel.apply(bias, mesh)[mesh.model_index * k:
                                   (mesh.model_index + 1) * k]
    y = torch.nn.functional.linear(x, weight, b)
    return _GatherColumns.apply(y, mesh)
