"""Training runtime (PyTorch port of dodt_tpu/runtime/trainer.py): the
optimiser chain written to optax's update rules, the train step,
checkpoints with named-subtree transfer, and the train loop.

State is functional, as in the JAX package: ``TrainState.params`` is a
dict of tensors keyed by ``DtAvodNet.state_dict()`` names, and the step
runs the model through ``torch.func.functional_call`` and returns a new
state. The optimiser follows optax exactly, where torch's built-ins do
not: ``clip_by_global_norm`` scales by max/||g|| with no epsilon,
frozen leaves get zero gradients *before* the clip (optax.masked
(set_to_zero) leads the chain), so they leave the clip norm and Adam's
nonzero moments still move them; the staircase decay counts from 0;
rmsprop's decay is 0.9 with eps inside the square root, momentum is
0.9 with no dampening.

Randomness comes from explicit generators: step ``s`` draws from a
generator seeded with (SEED, s), the analogue of the JAX step's
``fold_in(rng, step)``, so a resumed run repeats an uninterrupted one.

With a ``mesh`` (parallel/mesh.py) the trainer runs in every rank of the
process group, SPMD style, with JAX's global-batch semantics: each rank
loads the same global batch from the same stream and keeps its rows,
draws the global uniforms and keeps its rows, and the gradients and
losses are averaged over the data ranks in one flat all-reduce; the FC
trunks' weights, their moments and EMA are sharded over the model ranks
(the replicated leaves' gradients averaged over them, so their copies
stay identical), and the clip's global norm counts every sharded leaf
once, in full.
Global rank 0 writes the checkpoints, gathered to full tensors in the
meshless format, while the others wait at a barrier.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from dodt_tpu_torch.config import PipelineConfig
from dodt_tpu_torch.models import dt_avod
from dodt_tpu_torch.parallel import mesh as mesh_lib
from dodt_tpu_torch.utils.metrics import MetricsLogger, span

Params = Dict[str, torch.Tensor]
SEED = 42                    # the JAX Trainer's PRNGKey(42)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Dict[str, Any]
    ema_params: Optional[Params] = None

    def _replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_lr_schedule(cfg: PipelineConfig) -> Callable[[int], np.float32]:
    """optax.exponential_decay in float32: lr(count) = initial_lr *
    decay_factor ** (count / decay_steps), floored with staircase,
    counted from 0."""
    opt = cfg.train.optimizer
    init = np.float32(opt.initial_lr)

    def schedule(count: int) -> np.float32:
        if count <= 0:
            return init
        p = np.float32(count) / np.float32(opt.decay_steps)
        if opt.staircase:
            p = np.floor(p)
        return np.float32(init * np.power(np.float32(opt.decay_factor), p))
    return schedule


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """x rounded to float32 as a scalar tensor beside ``like``."""
    return torch.tensor(np.float32(x), dtype=like.dtype, device=like.device)


class Optimizer:
    """optax.chain(masked(set_to_zero, frozen), clip_by_global_norm,
    adam | sgd(momentum=0.9) | rmsprop | sgd, with the decay schedule).

    ``opt_state``: {"schedule_count"} plus, per name, adam {"count",
    "mu", "nu"}, momentum {"trace"}, rmsprop {"nu"} (dicts of tensors
    keyed like the params). On a mesh, ``sharded`` names the leaves that
    hold one block of rows per model rank: the clip's norm sums their
    squares over the model group."""

    B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adam defaults
    MOMENTUM = 0.9
    RMS_DECAY, RMS_EPS = 0.9, 1e-8          # optax.rmsprop defaults

    def __init__(self, cfg: PipelineConfig,
                 frozen_mask: Optional[Dict[str, bool]] = None,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 sharded: Optional[Dict[str, bool]] = None):
        self.cfg = cfg
        self.name = cfg.train.optimizer.name
        self.max_norm = cfg.train.optimizer.grad_clip_norm
        self.frozen = frozen_mask or {}
        self.mesh = mesh
        self.sharded = sharded or {}
        self.schedule = make_lr_schedule(cfg)

    def init(self, params: Params) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}
        state: Dict[str, Any] = {"schedule_count": 0}
        if self.name == "adam":
            state.update(count=0, mu=zeros(), nu=zeros())
        elif self.name == "momentum":
            state["trace"] = zeros()
        elif self.name == "rmsprop":
            state["nu"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any]):
        """(grads, state) -> (updates, new state); updates are added to
        the params."""
        g = {k: torch.zeros_like(v) if self.frozen.get(k) else v
             for k, v in grads.items()}
        like = next(iter(g.values()))
        # every scalar once per call, as a float32 tensor on the device
        # (one host-to-device copy each, not one per parameter tensor)
        c = {}

        def f32(x):
            if x not in c:
                c[x] = _f32(x, like)
            return c[x]

        squares = mesh_lib.sum_over_shards(
            [torch.sum(t * t) for t in g.values()],
            [self.sharded.get(k, False) for k in g], self.mesh)
        norm = torch.sqrt(sum(squares))
        keep = norm < self.max_norm
        g = {k: torch.where(keep, t, t / norm * f32(self.max_norm))
             for k, t in g.items()}
        new: Dict[str, Any] = {}
        if self.name == "adam":
            b1, b2 = self.B1, self.B2
            count = state["count"] + 1
            mu = {k: f32(1 - b1) * t + f32(b1) * state["mu"][k]
                  for k, t in g.items()}
            nu = {k: f32(1 - b2) * t * t + f32(b2) * state["nu"][k]
                  for k, t in g.items()}
            c1 = np.float32(1) - np.power(np.float32(b1), np.float32(count))
            c2 = np.float32(1) - np.power(np.float32(b2), np.float32(count))
            u = {k: (mu[k] / f32(c1))
                 / (torch.sqrt(nu[k] / f32(c2)) + f32(self.EPS))
                 for k in g}
            new.update(count=count, mu=mu, nu=nu)
        elif self.name == "momentum":
            u = {k: t + f32(self.MOMENTUM) * state["trace"][k]
                 for k, t in g.items()}
            new["trace"] = u
        elif self.name == "rmsprop":
            d = self.RMS_DECAY
            nu = {k: f32(1 - d) * t * t + f32(d) * state["nu"][k]
                  for k, t in g.items()}
            u = {k: t * torch.rsqrt(nu[k] + f32(self.RMS_EPS))
                 for k, t in g.items()}
            new["nu"] = nu
        else:
            u = g
        lr = f32(-self.schedule(state["schedule_count"]))
        u = {k: lr * t for k, t in u.items()}
        new["schedule_count"] = state["schedule_count"] + 1
        return u, new


def make_optimizer(cfg: PipelineConfig,
                   frozen_mask: Optional[Dict[str, bool]] = None,
                   mesh: Optional[mesh_lib.Mesh] = None,
                   sharded: Optional[Dict[str, bool]] = None) -> Optimizer:
    return Optimizer(cfg, frozen_mask, mesh, sharded)


def top_level(name: str) -> str:
    """The top-level subtree of a state-dict key ("rpn_cls.fc6.weight"
    -> "rpn_cls"), the Flax tree's top-level module name."""
    return name.split(".", 1)[0]


def frozen_mask_from_subtrees(params: Params, frozen_subtrees
                              ) -> Dict[str, bool]:
    """True for leaves under any of the named top-level subtrees."""
    return {k: top_level(k) in frozen_subtrees for k in params}


def create_train_state(cfg: PipelineConfig, model: torch.nn.Module
                       ) -> TrainState:
    """The model's current parameters (made by ``init_params`` or loaded)
    as step 0. The optimiser always carries the (possibly all-False)
    frozen mask, so every configuration of a model has one opt_state
    layout and a full state restores across the staged presets."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    frozen = frozen_mask_from_subtrees(params,
                                       cfg.train.frozen_subtrees or ())
    opt_state = make_optimizer(cfg, frozen).init(params)
    ema = ({k: v.clone() for k, v in params.items()}
           if cfg.train.optimizer.use_moving_average else None)
    return TrainState(step=0, params=params, opt_state=opt_state,
                      ema_params=ema)


def model_losses(model: torch.nn.Module) -> Callable:
    """The model family's loss function (JAX trainer.py:106-108). Both
    families define ``loss_builder``; a module without one (the bare
    modules the entry-point tests build a Trainer around) gets
    ``dt_avod.compute_losses``, as in JAX."""
    if hasattr(model, "loss_builder"):
        return model.loss_builder()
    return dt_avod.compute_losses


def make_train_step(cfg: PipelineConfig, model: torch.nn.Module,
                    mesh: Optional[mesh_lib.Mesh] = None):
    """(state, batch, rand) -> (new state, losses): one forward in train
    mode (dropout, path drop, sampling from ``rand``), the model's
    losses (``model_losses``), autograd gradients of every parameter, the
    optimiser update and the EMA. Losses stay on the device.

    With a ``mesh`` the state is ``mesh.shard_train_state``'s, the batch
    this rank's rows (``mesh.shard_batch``) and ``rand`` the global draws,
    as in the JAX step; the gradients and losses are averaged over the
    data ranks and the replicated leaves' gradients over the model ranks,
    and ``step_fn.reduced_bytes`` holds the bytes those all-reduces
    carried in the last step."""
    sharded = (mesh_lib.shard_module(model, mesh) if mesh is not None
               else None)
    tx = make_optimizer(cfg, frozen_mask_from_subtrees(
        dict(model.named_parameters()), cfg.train.frozen_subtrees or ()),
        mesh, sharded)
    loss_fn = model_losses(model)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rand: dt_avod.Rand):
        if mesh is not None:
            rand = mesh_lib.shard_draws(rand, mesh)
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        out = torch.func.functional_call(
            model, params, (batch,),
            {"mode": "train", "train": True, "rand": rand})
        with span("dodt/losses"):
            total, losses = loss_fn(cfg, out, batch, rand)
        with span("dodt/backward"):
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if gr is None else gr
                     for (k, p), gr in zip(params.items(), grads)}
        if mesh is not None:
            with span("dodt/all_reduce"):
                grads, losses, over_data = mesh_lib.reduce_over_data(
                    grads, losses, mesh)
                grads, over_model = mesh_lib.mean_over_model(grads, sharded,
                                                             mesh)
            step_fn.reduced_bytes = over_data + over_model
        with span("dodt/optimizer"), torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state)
            new_params = {k: p.detach() + updates[k]
                          for k, p in params.items()}
            ema = state.ema_params
            if ema is not None:
                d = cfg.train.optimizer.moving_average_decay
                like = next(iter(ema.values()))
                keep, take = _f32(d, like), _f32(1 - d, like)
                ema = {k: keep * e + take * new_params[k]
                       for k, e in ema.items()}
        losses = {k: v.detach() for k, v in losses.items()}
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=opt_state, ema_params=ema), losses

    step_fn.reduced_bytes = 0
    step_fn.sharded = sharded
    return step_fn


# ---------------------------------------------------------------------------
# Checkpoints


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def _same_layout(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_layout(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape
    return isinstance(a, torch.Tensor) == isinstance(b, torch.Tensor)


class CheckpointIO:
    """One directory per step, ``<dir>/<step>/train_state.pt``: params,
    optimiser state, step and EMA params (CPU tensors, torch.save).
    A checkpoint appears atomically (written beside, then renamed)."""

    FILE = "train_state.pt"

    def __init__(self, ckpt_dir: str, max_to_keep: int = 10000):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def save(self, step: int, state: TrainState):
        """Full train state: params + optimiser moments + EMA params."""
        payload = {"params": _to(state.params, "cpu"), "step": int(step),
                   "opt_state": _to(state.opt_state, "cpu")}
        if state.ema_params is not None:
            payload["ema_params"] = _to(state.ema_params, "cpu")
        final = os.path.join(self.dir, str(int(step)))
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(payload, os.path.join(tmp, self.FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """Re-lists the directory on every call: another process (a
        trainer beside the evaluator) may have written new steps."""
        return sorted(int(n) for n in os.listdir(self.dir)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.dir, n, self.FILE)))

    def _load(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self.dir, str(step), self.FILE),
                          map_location="cpu", weights_only=True)

    def restore_params(self, step: Optional[int] = None,
                       prefer_ema: bool = False) -> Optional[Params]:
        """Params for inference; with ``prefer_ema`` the EMA params when
        the checkpoint carries them."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        restored = self._load(step)
        if prefer_ema and restored.get("ema_params") is not None:
            return restored["ema_params"]
        return restored["params"]

    def restore_state(self, template: TrainState,
                      step: Optional[int] = None) -> Optional[TrainState]:
        """The full train state in the layout and on the device of
        ``template``, so a resumed run repeats an uninterrupted one;
        params only (template's optimiser state, the checkpoint's step)
        for a checkpoint whose optimiser state does not fit."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        restored = self._load(step)
        dev = next(iter(template.params.values())).device
        params = _to(restored["params"], dev)
        fits = (_same_layout(restored.get("opt_state"), template.opt_state)
                and (template.ema_params is None)
                == (restored.get("ema_params") is None))
        if not fits:
            return template._replace(params=params, step=int(step))
        ema = restored.get("ema_params")
        return TrainState(step=int(step), params=params,
                          opt_state=_to(restored["opt_state"], dev),
                          ema_params=None if ema is None else _to(ema, dev))

    def restore_subtrees(self, params: Params, source_dir: str,
                         subtrees=None, step: Optional[int] = None
                         ) -> Params:
        """Copy top-level subtrees from another run's checkpoint into
        ``params``. ``subtrees`` None: every top-level name both have;
        a tuple: exactly those, raising KeyError if any is missing on
        either side; (): nothing."""
        src = CheckpointIO(source_dir).restore_params(step)
        if src is None:
            raise FileNotFoundError(f"no checkpoint in {source_dir}")
        src_names = {top_level(k) for k in src}
        dst_names = {top_level(k) for k in params}
        if subtrees is None:
            names = src_names & dst_names
        else:
            names = set(subtrees)
            missing = [n for n in subtrees
                       if n not in src_names or n not in dst_names]
            if missing:
                raise KeyError(
                    f"pretrained_subtrees not found (src={source_dir}): "
                    f"{missing}; source has {sorted(src_names)}, target "
                    f"has {sorted(dst_names)}")
        out = dict(params)
        for k in params:
            if top_level(k) in names:
                out[k] = src[k].to(params[k].device)
        return out


# ---------------------------------------------------------------------------
# Train loop


class Trainer:
    def __init__(self, cfg: PipelineConfig, model: torch.nn.Module,
                 dataset, ckpt_dir: str,
                 mesh: Optional[mesh_lib.Mesh] = None, batch_size: int = 1,
                 metrics_path: Optional[str] = "auto", device="cuda"):
        """Trains on ``device``, the card unless the caller asks for the
        CPU, and moves the model there. With a ``mesh``, every rank runs
        this trainer; ``batch_size`` is the global batch, which must
        split evenly over the data ranks."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.mesh = mesh
        self.batch_size = batch_size
        if mesh is not None and batch_size % mesh.num_data:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{mesh.num_data} data ranks")
        self.writes = mesh is None or torch.distributed.get_rank() == 0
        self.ckpt = CheckpointIO(ckpt_dir, cfg.train.max_checkpoints_to_keep)
        # window-averaged losses as JSONL next to the checkpoints
        if metrics_path == "auto":
            metrics_path = os.path.join(ckpt_dir, "train_metrics.jsonl")
        self.metrics = MetricsLogger(metrics_path if self.writes else None)
        self.step_fn = make_train_step(cfg, self.model, mesh)
        self._spare_batches: list = []  # prefetched across train() calls

    def draws(self, step: int) -> dt_avod.Rand:
        """Step ``step``'s draws, from a generator on the model's device
        seeded with (SEED, step)."""
        g = torch.Generator(self.device)
        g.manual_seed((SEED << 32) + step)
        return dt_avod.generator_draws(g)

    def init_or_restore(self) -> TrainState:
        state = create_train_state(self.cfg, self.model)
        latest = self.ckpt.latest_step()
        tcfg = self.cfg.train
        if latest is not None:
            state = self.ckpt.restore_state(state, latest)
        elif tcfg.pretrained_checkpoint:
            if tcfg.pretrained_full_state:
                # the staged flow's joint finetune: params, step, moments
                # and EMA continue from the previous stage
                restored = CheckpointIO(
                    tcfg.pretrained_checkpoint).restore_state(state)
                if restored is None:
                    raise FileNotFoundError(
                        "pretrained_full_state: no checkpoint in "
                        f"{tcfg.pretrained_checkpoint}")
                state = restored
            else:
                params = self.ckpt.restore_subtrees(
                    state.params, tcfg.pretrained_checkpoint,
                    tcfg.pretrained_subtrees)
                # keep the EMA coherent with the restored params
                ema = ({k: v.clone() for k, v in params.items()}
                       if state.ema_params is not None else None)
                state = state._replace(params=params, ema_params=ema)
        if self.mesh is not None:
            state = mesh_lib.shard_train_state(state, self.mesh)
        return state

    def save(self, step: int, state: TrainState):
        """Checkpoint ``state``; on a mesh its shards are gathered first
        and global rank 0 writes while the others wait."""
        if self.mesh is None:
            return self.ckpt.save(step, state)
        full = mesh_lib.gather_train_state(state, self.mesh,
                                           self.step_fn.sharded)
        if self.writes:
            self.ckpt.save(step, full)
        torch.distributed.barrier()

    def _device_batch(self, augment=True) -> Dict[str, torch.Tensor]:
        batch = self.dataset.next_batch(self.batch_size, augment=augment)
        if self.mesh is not None:
            batch = mesh_lib.shard_batch(batch, self.mesh)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def train(self, max_steps: Optional[int] = None, log_every: int = 10,
              prefetch: int = 2):
        """Train loop; a background thread loads and copies the next
        ``prefetch`` batches while the card runs the current step.
        Returns (final state, logged history).

        Under a profiler each iteration is the span ``dodt/train_step``,
        holding ``dodt/data_wait``, the step function's spans
        (``dodt/forward``, ``dodt/losses``, ``dodt/backward``,
        ``dodt/all_reduce`` on a mesh, ``dodt/optimizer``), and at log
        and checkpoint points ``dodt/log`` (the loss fetch) and
        ``dodt/save``."""
        state = self.init_or_restore()
        max_steps = max_steps or self.cfg.train.max_iterations
        history = []
        t0 = time.time()
        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()
        producer_err = []

        def _producer():
            try:
                while not stop.is_set():
                    batch = self._device_batch()
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surface instead of a silent hang
                producer_err.append(e)
                stop.set()

        def _next_prefetched():
            if self._spare_batches:
                return self._spare_batches.pop(0)
            while True:
                try:
                    return q.get(timeout=5.0)
                except queue.Empty:
                    if producer_err:
                        raise RuntimeError(
                            "prefetch producer failed") from producer_err[0]
                    if not producer.is_alive():
                        raise RuntimeError("prefetch producer died")

        producer = None
        if prefetch > 0:
            producer = threading.Thread(target=_producer, daemon=True)
            producer.start()
        # debug_nans: anomaly detection names the backward op that made a
        # NaN, and a non-finite loss stops the run
        anomaly = (torch.autograd.detect_anomaly(check_nan=True)
                   if self.cfg.train.debug_nans else contextlib.nullcontext())
        window = []  # device scalars; fetched only at log points
        step = int(state.step)
        try:
            with anomaly:
                while step < max_steps:
                    with span("dodt/train_step"):
                        with span("dodt/data_wait"):
                            batch = (_next_prefetched() if producer
                                     else self._device_batch())
                        state, losses = self.step_fn(state, batch,
                                                     self.draws(step))
                        if self.cfg.train.debug_nans and not bool(
                                torch.isfinite(losses["total"])):
                            raise FloatingPointError(
                                f"non-finite loss at step {step}: {losses}")
                        window.append(losses)
                        step += 1
                        if step % log_every == 0 or step == max_steps:
                            with span("dodt/log"):
                                logged = {k: float(torch.stack(
                                    [w[k] for w in window]).mean())
                                    for k in window[0]}
                            window = []
                            logged["step"] = step
                            logged["wall_s"] = time.time() - t0
                            history.append(logged)
                            self.metrics.log(step, **{
                                k: v for k, v in logged.items()
                                if k != "step"})
                        if step % self.cfg.train.checkpoint_interval == 0 \
                                or step == max_steps:
                            with span("dodt/save"):
                                self.save(step, state)
        finally:
            stop.set()
            if producer is not None:
                while producer.is_alive():
                    try:  # unblock a producer stuck on a full queue
                        self._spare_batches.append(q.get_nowait())
                    except queue.Empty:
                        pass
                    producer.join(timeout=0.2)
                while True:  # keep loaded batches for the next train()
                    try:
                        self._spare_batches.append(q.get_nowait())
                    except queue.Empty:
                        break
        return state, history
