"""The comparison that decides ``correct``: what the timed path produced
on the calls an entry kept, against the plain reference (``reference/``)
run on the same weights, inputs and draws after the window, once the
program's state is freed. Each entry (``entries/<entry>.py``) reduces
its numbers over the kept calls by their largest value; ``correct``
holds when every number is finite and within its limit
(``limits/<cell>.json``). The helpers here are shared by the entries.

Past the RPN's NMS the reference follows the program: the program's
proposals are read, like a served model's tokens, and the reference's
second stage runs on them (``reference.model.force_proposals``: their
values, with the gradient of the reference's own candidate at the same
anchor). NMS over near-tied random scores picks other proposals at
another rounding, so the second stage is judged on the proposals the
program chose, and the choice itself by ``proposal_miss``. In training
the reference also takes the two-pass RPN's candidates in the program's
rank order (``interest``): a dropout draw belongs to a row of them, and
near-tied scores ranked in another order would hand the rows other
draws.

  bev_gap        largest |program - reference| of the rasterized BEV
                 input (exact: the same arithmetic on both sides)
  feat_gap       largest |program - reference| of the frame's BEV and
                 image tower outputs over the reference's largest |value|
  proposal_miss  the share of the valid proposals of either side (the
                 program's and the reference's own NMS output) with no
                 proposal of the other within MATCH_TOL on every value
  final_gap      for each valid final detection of the program, its gap
                 to the reference's prediction on the same proposal, each
                 part over the frame's largest reference value of that
                 part: the box against the regression, the object logit,
                 the angle head, the correlation offsets
  loss_gap       the relative gap of the total loss on the first step
                 and on each checked step of the window (the steps both
                 sides take from the same parameters)
  rpn_out_gap    the RPN outputs (objectness and offsets) on the sampled
                 mini-batch of the first step and of each checked step of
                 the window (the steps both sides take from the same
                 parameters): largest |program - reference| over the
                 reference's largest |value|
  change_gap     the parameters' change by its worst leaf: the gap
                 between the program's and the reference's norm of the
                 leaf's change over the larger of the reference's norm of
                 that leaf and of the median leaf; over the start's steps,
                 and over each checked step of the window

The start's steps are followed from the seed's weights; a window step
from the program's state before it (its parameters and Adam state).
The start's later steps run from the reference's own parameters, after
Adam's first update, which moves each weight by about the learning
rate in the direction of its gradient's sign: a near-zero gradient
entry that the configuration's bfloat16 rounds to the other sign moves
its weight the other way. Their loss and RPN outputs swing from seed to
seed with those signs, so they are written as notes and not compared;
the start's change (``change_gap``) covers those steps.
The gradient as Adam got it ((mu' - b1 mu) / (1 - b1)), by the same
worst leaf, is written as a note for the first step and for each window
step, and not compared: at the configuration's bfloat16 towers it
swings from seed to seed as far as the float8 control and the
state-left-unchanged fault read, while the program's own float32 towers
meet the reference to about 1e-6 (the leaves behind the one-channel
RPN bottleneck's GroupNorm amplify the rounding).
Leaves whose reference gradient stays under GRAD_FLOOR of the median
leaf's (on every step of the start; on the step, in the window) are
left out of grad_gap and change_gap: a bias under softmax, which Adam
moves by round-off alone."""
from __future__ import annotations

import contextlib
import json
import math
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reference import optim as ref_optim
from reference.config import PipelineConfig as RefConfig
from harness.cells import family_of
from harness.weights import load_into

MATCH_TOL = 0.05
GRAD_FLOOR = 1e-3


def reference(config: Dict, weights: Dict[str, torch.Tensor],
              device: torch.device, precision: str = "float32",
              family=None):
    """The reference's configuration and model of the configuration file
    ``config``, built by its family (``harness.cells.family_of`` where
    none is given), holding ``weights``, on ``device``."""
    cfg = RefConfig.from_json(json.dumps(config["pipeline"]))
    family = family or family_of(config)
    net = family.reference(cfg, config, precision)
    load_into(net, weights)
    return cfg, net.to(device).eval()


def on(frame: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in frame.items()}


def miss_share(a, a_valid, b, b_valid, tol: float = MATCH_TOL) -> float:
    """The share of the valid boxes of both sides with no box of the
    other side within ``tol`` on every coordinate."""
    a = torch.as_tensor(a, dtype=torch.float64)[torch.as_tensor(a_valid)]
    b = torch.as_tensor(b, dtype=torch.float64)[torch.as_tensor(b_valid)]
    if len(a) + len(b) == 0:
        return 0.0
    if len(a) == 0 or len(b) == 0:
        return 1.0
    d = (a[:, None, :] - b[None, :, :]).abs().amax(-1)
    missed = int((d.amin(1) > tol).sum()) + int((d.amin(0) > tol).sum())
    return missed / (len(a) + len(b))


def rel(p: float, r: float) -> float:
    """|p - r| / |r|: 0 where they are equal, infinite where only r is
    0."""
    return 0.0 if p == r else (abs(p - r) / abs(r) if r else math.inf)


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.to(torch.float32), r.to(torch.float32)
    return float((p - r).abs().amax() / r.abs().amax().clamp_min(1e-30))


@contextlib.contextmanager
def counting(flops: Optional[list]):
    """Counts the FLOPs of the block into ``flops`` (a list to append
    to) when it is given."""
    if flops is None:
        yield
        return
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        yield
    flops.append(float(counter.get_total_flops()))


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out.get(k, -math.inf), v) if math.isfinite(v) \
                else math.nan
    return out


def proposal_miss(prog_anchors, prog_valid, own_anchors, own_valid
                  ) -> float:
    """The share of the valid (M, K, 6) proposals of either side (the
    program's and the reference's own NMS output) with no proposal of the
    other within MATCH_TOL on every value, over the M frames' largest."""
    return max(miss_share(p.cpu(), pv.cpu(), o.cpu(), ov.cpu())
               for p, pv, o, ov in zip(prog_anchors, prog_valid, own_anchors,
                                       own_valid))


def forced_miss(prog_valid, hit) -> float:
    """The share of the program's valid proposals that no candidate of
    the reference matched (``force_proposals``)."""
    valid = prog_valid.bool()
    return float((valid & ~hit).sum()) / max(int(valid.sum()), 1)


def final_gap(finals: Dict[str, np.ndarray], second: Dict,
              notes: Optional[List[str]] = None) -> float:
    """For each valid final detection of the program, the reference's
    prediction on the same proposal (the one whose box lies nearest), and
    the largest of: the box's gap (centre, sides, height, the decoded
    orientation round the circle) over the frame's largest regression
    (prediction - proposal), the object logit's gap over the frame's
    largest |logit|, for the angle head the reference's angle vector
    across the program's orientation over the frame's largest vector,
    and for the first frame of a pair the correlation offsets' gap over
    their largest |value|."""
    gap, worst_note = 0.0, None
    valid_all = torch.as_tensor(finals["final_valid"][0]).bool()
    for f in range(valid_all.shape[0]):
        valid = valid_all[f]
        if not bool(valid.any()):
            continue
        ref_box = second["pred_boxes_3d"][0, f].double().cpu()
        prop = second["proposal_boxes_3d"][0, f].double().cpu()
        box = torch.as_tensor(finals["final_boxes_3d"][0, f]).double()[valid]
        d = (box[:, None] - ref_box[None]).abs()
        d[..., 6] = torch.remainder(d[..., 6] + math.pi, 2 * math.pi).sub(
            math.pi).abs()
        near, j = d.amax(-1).min(1)
        reg = (ref_box - prop).abs()
        reg[:, 6] = torch.remainder(reg[:, 6] + math.pi, 2 * math.pi).sub(
            math.pi).abs()
        parts = {"box": near / reg.amax().clamp_min(1e-12)}
        ref_p = torch.softmax(second["cls_logits"][0, f].double().cpu(),
                              -1)[:, 1:].amax(-1).clamp(1e-12, 1 - 1e-12)
        prog_p = torch.as_tensor(finals["final_scores"][0, f]).double()[
            valid].clamp(1e-12, 1 - 1e-12)
        ref_logit = torch.log(ref_p / (1 - ref_p))
        parts["score"] = (torch.log(prog_p / (1 - prog_p)) - ref_logit[j]
                          ).abs() / ref_logit.abs().amax().clamp_min(1e-12)
        if second.get("angle_vectors") is not None:
            vec = second["angle_vectors"][0, f].double().cpu()
            ry = torch.as_tensor(finals["final_orientations"][0, f]
                                 ).double()[valid]
            across = (vec[j, 1] * torch.cos(ry) - vec[j, 0] * torch.sin(ry))
            parts["angle"] = across.abs() / vec.norm(dim=-1).amax().clamp_min(
                1e-12)
        if f == 0 and "corr_pred" in second:
            corr = second["corr_pred"][0].double().cpu()
            prog_c = torch.as_tensor(finals["final_corr_offsets"][0]
                                     ).double()[valid]
            parts["corr"] = (prog_c - corr[j]).abs().amax(-1) / \
                corr.abs().amax().clamp_min(1e-12)
        for name, v in parts.items():
            if float(v.max()) >= gap:
                gap = float(v.max())
                worst_note = f"final_gap {gap:.6g}: {name}, frame {f}"
    if notes is not None and worst_note:
        notes.append(worst_note)
    return gap


def rpn_rows(out: Dict) -> Dict[str, torch.Tensor]:
    """A train-mode forward's RPN outputs on rows whose order does not
    depend on scores: the sampled mini-batch of the two-pass RPN, or
    every anchor of the single pass."""
    if "rpn_mb" in out:
        return {k: out["rpn_mb"][k] for k in ("objectness", "offsets")}
    return {"objectness": out["objectness"], "offsets": out["rpn_offsets"]}


def replay(draws: List[Tuple[str, torch.Tensor]]):
    """``rand`` handing back recorded draws by name, in the order each
    name was drawn."""
    by = defaultdict(deque)
    for name, u in draws:
        by[name].append(u)

    def rand(name, shape):
        u = by[name].popleft()
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draw {name}: recorded {tuple(u.shape)}, the "
                             f"reference asks for {tuple(shape)}")
        return u
    return rand


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keys: List[str], notes: List[str], what: str) -> float:
    """The worst leaf's gap between the program's and the reference's
    norm, over the larger of the reference's norm of the leaf and of the
    median leaf; the three worst and the median gap go to ``notes``."""
    pn = {k: float(prog[k].double().norm()) for k in keys}
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}
    worst_keys = sorted(gaps, key=gaps.get)[-3:]
    notes.append(f"{what}: {len(keys)} leaves, median leaf norm {med:.6g}, "
                 f"median gap {float(np.median(list(gaps.values()))):.6g}, "
                 "worst " + ", ".join(f"{k} {gaps[k]:.6g} ({pn[k]:.6g}/"
                                      f"{rn[k]:.6g})" for k in worst_keys))
    return max(gaps.values())


def adam_grad(after: Dict, before: Dict) -> Dict[str, torch.Tensor]:
    """The gradient an Adam step got, from its first moment before and
    after: (mu' - b1 mu) / (1 - b1)."""
    b1 = ref_optim.B1
    return {k: (m - b1 * before["mu"][k]) / (1 - b1)
            for k, m in after["mu"].items()}


def above_floor(norms: Dict[str, float]) -> List[str]:
    floor = GRAD_FLOOR * float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= floor]


def train_numbers(config, weights, device, couples, captures,
                  precision="float32", flops=None, notes=None, family=None
                  ) -> Dict[str, float]:
    """The train entry's comparison (module docstring): captures of kind
    "start" (the first steps, in order) and "window"."""
    from harness.inputs import PoolDataset
    cfg, net = reference(config, weights, device, precision, family)
    notes = [] if notes is None else notes
    start = [c for c in captures if c["kind"] == "start"]
    window = [c for c in captures if c["kind"] == "window"]
    numbers = []

    def step(c, params, opt, what, count_flops=False):
        with counting(flops if count_flops else None):
            new, opt2, losses, grads, out = ref_optim.train_step(
                cfg, net, params, opt,
                on(PoolDataset.batch(couples, c["couples"]), device),
                replay(c["draws"]), proposals=c["proposals"],
                interest=c["interest"])
        rows = rpn_rows(out)
        n = {"loss_gap": rel(float(c["losses"]["total"]),
                             float(losses["total"])),
             "rpn_out_gap": max(rel_gap(c["rpn_mb"][k], rows[k])
                                for k in rows)}
        notes.append(
            f"{what}: loss_gap {n['loss_gap']:.6g}, rpn_out_gap "
            f"{n['rpn_out_gap']:.6g}, forced_miss "
            f"{forced_miss(c['proposals'][1], out['forced_hit'])}, "
            "interest_miss " + (
                str(float(out["interest_miss"].max()))
                if "interest_miss" in out else "none") +
            "; losses program/reference " + " ".join(
                f"{k} {float(c['losses'][k]):.6g}/{float(v):.6g}"
                for k, v in losses.items()) + "; own NMS against the "
            "program's, miss " + str(proposal_miss(
                c["proposals"][0].flatten(0, 1),
                c["proposals"][1].flatten(0, 1),
                out["own_top_anchors"].flatten(0, 1),
                out["own_top_valid"].flatten(0, 1))))
        norms = {k: float(g.double().norm()) for k, g in grads.items()}
        return new, opt2, n, norms

    # the start, followed from the seed's weights
    params = {k: v.clone() for k, v in weights.items()}
    opt = ref_optim.adam_init(params)
    gmax: Dict[str, float] = defaultdict(float)
    for i, c in enumerate(start):
        before = opt
        params, opt, n, norms = step(c, params, opt, f"start step {i + 1}",
                                     count_flops=i == 0)
        if i > 0:
            # from the reference's own parameters, which Adam's first
            # steps move by round-off where a gradient is near 0
            del n["loss_gap"], n["rpn_out_gap"]
        else:
            # a note (module docstring)
            leaf_gap(
                adam_grad(c["after"].opt_state, c["before"].opt_state),
                adam_grad(opt, before), above_floor(norms), notes,
                "grad, start step 1")
        for k, v in norms.items():
            gmax[k] = max(gmax[k], v)
        numbers.append(n)
    if start:
        keys = above_floor(gmax)
        numbers.append({"change_gap": leaf_gap(
            {k: start[-1]["after"].params[k] - start[0]["before"].params[k]
             for k in keys},
            {k: params[k] - weights[k] for k in keys}, keys, notes,
            f"change, start steps 1-{len(start)}")})
    del params, opt
    # the window's steps, each from the program's state before it
    for c in window:
        b = c["before"]
        opt = {"count": int(b.opt_state["count"]), "mu": b.opt_state["mu"],
               "nu": b.opt_state["nu"]}
        what = f"window step {c['step'] + 1}"
        new, opt2, n, norms = step(c, b.params, opt, what)
        keys = above_floor(norms)
        # a note: the worst leaf of a later step's gradient is not steady
        # at the configuration's bfloat16 (module docstring)
        leaf_gap(adam_grad(c["after"].opt_state, opt),
                 adam_grad(opt2, opt), keys, notes, "grad, " + what)
        n["change_gap"] = leaf_gap(
            {k: c["after"].params[k] - b.params[k] for k in keys},
            {k: new[k] - b.params[k] for k in keys}, keys, notes,
            "change, " + what)
        numbers.append(n)
        del new, opt2
    return worst(numbers)
