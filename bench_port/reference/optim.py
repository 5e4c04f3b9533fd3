"""The reference's train step: the optimiser chain of
``dodt_tpu_torch/runtime/trainer.py`` (optax's update rules) for the
configuration the benchmark trains, clip_by_global_norm (max / ||g||,
no epsilon) then Adam with the staircase decay counted from 0, and one
step of forward, losses, autograd gradients and update, in float32."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call

from .config import PipelineConfig
from .model import Rand, compute_losses

Params = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adam defaults

def learning_rate(cfg: PipelineConfig, count: int) -> np.float32:
    """optax.exponential_decay in float32, counted from 0."""
    opt = cfg.train.optimizer
    init = np.float32(opt.initial_lr)
    if count <= 0:
        return init
    p = np.float32(count) / np.float32(opt.decay_steps)
    if opt.staircase:
        p = np.floor(p)
    return np.float32(init * np.power(np.float32(opt.decay_factor), p))

def adam_init(params: Params) -> Dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v)
                               for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

@torch.no_grad()
def adam_update(cfg: PipelineConfig, grads: Params, state: Dict
                ) -> Tuple[Params, Dict]:
    """(grads, state) -> (updates, new state): the global-norm clip, then
    Adam, then the learning rate of the state's count."""
    opt = cfg.train.optimizer
    if opt.name != "adam" or cfg.train.frozen_subtrees:
        raise ValueError("the reference step holds Adam on every leaf")
    max_norm = np.float32(opt.grad_clip_norm)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    g = {k: torch.where(keep, t, t / norm * max_norm)
         for k, t in grads.items()}
    count = state["count"] + 1
    mu = {k: (1 - B1) * t + B1 * state["mu"][k] for k, t in g.items()}
    nu = {k: (1 - B2) * t * t + B2 * state["nu"][k] for k, t in g.items()}
    c1 = np.float32(1) - np.power(np.float32(B1), np.float32(count))
    c2 = np.float32(1) - np.power(np.float32(B2), np.float32(count))
    lr = -learning_rate(cfg, state["count"])
    u = {k: float(lr) * ((mu[k] / float(c1))
                         / (torch.sqrt(nu[k] / float(c2)) + EPS))
         for k in g}
    return u, {"count": count, "mu": mu, "nu": nu}

def train_step(cfg: PipelineConfig, model: torch.nn.Module, params: Params,
               opt_state: Dict, batch: Dict[str, torch.Tensor], rand: Rand,
               proposals=None, interest=None):
    """One step: the train-mode forward with dropout, path drop and
    sampling from ``rand`` (its proposals at the selection ``proposals``
    gives, ``model.force_proposals``, and its two-pass candidates in the
    order ``interest`` gives, (B * F, fusion_top_k), when given), the
    losses, every
    leaf's gradient, the update. Returns (new params, new optimiser
    state, losses, the gradients before the clip, the forward's
    outputs without gradient)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    out = functional_call(model, leaves, (batch,),
                          {"mode": "train", "train": True, "rand": rand,
                           "proposals": proposals,
                           "interest": interest})
    total, losses = compute_losses(cfg, out, batch, rand)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    updates, opt_state = adam_update(cfg, grads, opt_state)
    new = {k: p.detach() + updates[k] for k, p in leaves.items()}
    kept = {k: v.detach() for k, v in out.items()
            if isinstance(v, torch.Tensor)}
    if "rpn_mb" in out:
        kept["rpn_mb"] = {k: v.detach() for k, v in out["rpn_mb"].items()}
    return (new, opt_state, {k: v.detach() for k, v in losses.items()},
            grads, kept)
