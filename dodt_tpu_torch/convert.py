"""Flax parameter tree <-> ``DtAvodNet.state_dict()``, JAX train states
and configs -> the port's.

The port's modules carry the Flax names, so a state-dict key is the Flax
path joined with dots, with the leaf names ``kernel`` and ``scale``
(GroupNorm) renamed to ``weight``; every other leaf keeps its name (the
s2d stem's flat ``conv1_{i}_kernel``, CorrBottleneck's ``bias``).
Arrays change layout by rank:

  4-D conv kernels        HWIO (kh, kw, ci, co) <-> OIHW (co, ci, kh, kw)
  2-D Dense kernels       (in, out) <-> (out, in); this includes
                          CorrBottleneck's (D^2, Cb) kernel
  1-D biases and scales   unchanged

Works on numpy arrays and never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight"}


def config_from_json(cfg):
    """Any pipeline config with ``to_json()`` (the JAX package's
    ``PipelineConfig``) -> the port's ``PipelineConfig`` with the same
    settings, through its JSON."""
    from dodt_tpu_torch.config import PipelineConfig
    return PipelineConfig.from_json(cfg.to_json())


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return np.transpose(a, (3, 2, 0, 1))
    if a.ndim == 2:
        return a.T
    return a


def _to_flax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return np.transpose(a, (2, 3, 1, 0))
    if a.ndim == 2:
        return a.T
    return a


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (a Flax ``params`` tree) -> state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (name,))
            else:
                key = ".".join(prefix + (_RENAME.get(name, name),))
                a = np.ascontiguousarray(_to_torch_layout(np.asarray(v)))
                out[key] = torch.from_numpy(a.copy())

    walk(params, ())
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """State dict -> nested dict of numpy arrays in Flax layout. A
    ``weight`` leaf becomes ``scale`` when 1-D (GroupNorm) and
    ``kernel`` otherwise."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "scale" if a.ndim == 1 else "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(_to_flax_layout(a))
    return tree


# ---------------------------------------------------------------------------
# Train state: a JAX TrainState (params, optax state, EMA) <-> the port's
# runtime.trainer.TrainState. optax's states are NamedTuples; they are read
# and rebuilt by their type names and fields, so optax is not imported.

_OPT_FIELDS = {"ScaleByAdamState": {"count": "count", "mu": "mu",
                                    "nu": "nu"},
               "TraceState": {"trace": "trace"},
               "ScaleByRmsState": {"nu": "nu"},
               "ScaleByScheduleState": {"count": "schedule_count"}}


def _walk_optax(node, out: Dict[str, Any]) -> None:
    fields = _OPT_FIELDS.get(type(node).__name__)
    if fields is not None:
        for f, key in fields.items():
            v = getattr(node, f)
            out[key] = (int(np.asarray(v)) if f == "count"
                        else flax_to_state_dict(v))
    elif isinstance(node, tuple):        # chains, MaskedState, EmptyState
        for child in node:
            _walk_optax(child, out)


def train_state_from_flax(state):
    """A JAX ``TrainState`` (leaves as numpy or JAX arrays) -> the port's
    ``TrainState`` on the CPU: params, optimiser moments and counts, EMA
    params and step, so a JAX run resumes in the port."""
    from dodt_tpu_torch.runtime.trainer import TrainState
    opt: Dict[str, Any] = {}
    _walk_optax(state.opt_state, opt)
    ema = state.ema_params
    return TrainState(step=int(np.asarray(state.step)),
                      params=flax_to_state_dict(state.params),
                      opt_state=opt,
                      ema_params=None if ema is None
                      else flax_to_state_dict(ema))


def _fill_optax(node, opt: Mapping[str, Any]):
    fields = _OPT_FIELDS.get(type(node).__name__)
    if fields is not None:
        return node._replace(**{
            f: (np.asarray(opt[key], np.int32) if f == "count"
                else state_dict_to_flax(opt[key]))
            for f, key in fields.items()})
    if hasattr(node, "_fields"):
        return node._replace(**{f: _fill_optax(getattr(node, f), opt)
                                for f in node._fields})
    if isinstance(node, tuple):
        return tuple(_fill_optax(child, opt) for child in node)
    return node


def train_state_to_flax(state, opt_template) -> Dict[str, Any]:
    """The port's ``TrainState`` -> {"step", "params", "opt_state",
    "ema_params"} in Flax layout as numpy arrays; ``opt_state`` is
    ``opt_template`` (the JAX optimiser's state for the same config)
    with every moment and count replaced."""
    return {"step": np.asarray(state.step, np.int32),
            "params": state_dict_to_flax(state.params),
            "opt_state": _fill_optax(opt_template, state.opt_state),
            "ema_params": None if state.ema_params is None
            else state_dict_to_flax(state.ema_params)}
