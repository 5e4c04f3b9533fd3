"""Entry ``stack``: closed loop. ``StackAvodNet.forward(batch,
mode="val")`` on the stack pool in turn, one stack of F frames a call
(B = 1), with every frame's detections, ``final_coexist`` and
``final_corr_offsets`` fetched to the host; a call's latency runs from
host arrays in to detections on the host. One call is one keyframe
interval.

The stack pool (``stack_pool``): ``mix["pool"]`` stacks, each one scene
of ``car_counts`` cars over the configuration's ``num_frames`` frames at
``mix["hz"]``. Each car moves along its heading at a speed drawn from
``mix["speed"]`` m/s. Each frame is a scan of ``valid_points`` returns,
its clutter drawn anew, with ``car_points`` on each car, and a seeded
image. The clouds are in frame 0's coordinates (ego-aligned, as the
Stack dataset hands them over).

The comparison, on the calls the reservoir keeps:

  bev_gap        the rasterized BEV inputs, every frame's and the
                 integrated one (read through a spy on the model
                 module's ``bev_maps_from_points``): exact
  proposal_miss  the proposals against the reference's own NMS
  final_gap      every frame's final detections against the reference's
                 second stage on the program's proposals
                 (``harness/check.final_gap``)
  corr_gap       the stack correlation head at frame 0's valid finals:
                 the corr offsets' largest gap over the reference's
                 largest |offset| on the valid proposals, and the
                 coexist probability's largest gap, whichever is larger
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import check as C
from harness import inputs
from harness.program import Run, Sampler, spy, sync
from harness.trace import trace

ROOT_SPAN = "dodt/forward"
KEYS = ("final_boxes_3d", "final_orientations", "final_cls_softmax",
        "final_scores", "final_valid", "final_indices", "final_coexist",
        "final_corr_offsets")


def moved(boxes: np.ndarray, speed: np.ndarray, seconds: float
          ) -> np.ndarray:
    """box_3d rows moved along their heading (the length axis, x cos ry,
    z -sin ry) by speed x seconds."""
    out = boxes.copy()
    out[:, 0] += np.cos(boxes[:, 6]) * speed * seconds
    out[:, 2] -= np.sin(boxes[:, 6]) * speed * seconds
    return out


def stack_pool(seed: int, mix: Dict, frames: int, capacity: int,
               image_hw) -> List[Dict]:
    """The mix's stacks (module docstring), each host arrays of one
    sample of ``frames`` frames in the keys the model takes."""
    out = []
    for i, n_cars in enumerate(inputs.car_counts(seed, mix, 3)):
        rng = inputs.rng_for(seed, 3, i)
        boxes = inputs.car_boxes(rng, n_cars, inputs.GROUND_PLANE[3])
        speed = rng.uniform(*mix["speed"], n_cars)
        pts, valid = zip(*(inputs.scan_with_cars(
            rng, moved(boxes, speed, t / mix["hz"]), mix["valid_points"],
            capacity, mix["car_points"]) for t in range(frames)))
        out.append({
            "points": np.stack(pts)[None],
            "points_valid": np.stack(valid)[None],
            "image": rng.uniform(0, 255, (1, frames, *image_hw, 3)
                                 ).astype(np.float32),
            "ground_plane": np.array([inputs.GROUND_PLANE], np.float32),
            "p2": np.array([inputs.KITTI_P2], np.float32),
            "orig_image_shape": np.array([inputs.ORIG_IMAGE_SHAPE],
                                         np.int32)})
    return out


def stacks(ctx) -> List[Dict]:
    """The run's stack pool, made once."""
    if getattr(ctx, "stacks", None) is None:
        d = ctx.pipeline["dataset"]
        ctx.stacks = stack_pool(ctx.seed, ctx.mix, ctx.config["num_frames"],
                                d["max_points"], tuple(d["image_shape"]))
    return ctx.stacks


def drive(ctx) -> Run:
    from dodt_tpu_torch.models import stack
    mix, dev, model = ctx.mix, ctx.device, ctx.model
    pool = stacks(ctx)
    n = len(pool)
    run = Run()
    hold: Dict = {}
    do_sync = sync(dev)

    def rasterize(real):
        def wrapped(*a, **k):
            maps = real(*a, **k)
            if "maps" in hold:
                hold["maps"].append(maps.features)
            return maps
        return wrapped

    def call(k):
        batch = {key: torch.as_tensor(v, device=dev)
                 for key, v in pool[k % n].items()}
        out = model(batch, mode="val")
        return out, {key: out[key].cpu().numpy() for key in KEYS}

    with spy(stack, "bev_maps_from_points", rasterize):
        warm = mix["warmup"]
        for k in range(warm):
            call(k)
        ctx.setup_done()
        sampler = Sampler(mix["checked"], ctx.rng)
        t0 = time.perf_counter()
        i = 0
        while True:
            slot = sampler.slot(i)
            if slot is not None:
                hold["maps"] = []
            ts = time.perf_counter()
            out, host = call(warm + i)
            te = time.perf_counter()
            run.latencies.append(te - ts)
            if slot is not None:
                sampler.kept[slot] = {
                    "cur": (warm + i) % n,
                    "maps": torch.stack(hold.pop("maps")),
                    "top_anchors": out["top_anchors"],
                    "top_valid": out["top_valid"], "finals": host}
            del out
            i += 1
            if te - t0 >= ctx.seconds:
                break
        run.window_s, run.calls = te - t0, i
        run.captures = sampler.items()
        ctx.window_done()
        if ctx.traced:
            k0 = warm + i
            run.trace = trace(lambda: [call(k0 + j) for j in
                                       range(mix["trace_calls"])], do_sync)
    return run


def corr_gap(finals: Dict[str, np.ndarray], out: Dict,
             notes: List[str]) -> float:
    """The stack correlation head's gap at frame 0's valid finals (module
    docstring); each final's proposal is the same row on both sides,
    since the reference runs on the program's proposals."""
    valid = torch.as_tensor(finals["final_valid"][0, 0]).bool()
    if not bool(valid.any()):
        return 0.0
    j = torch.as_tensor(finals["final_indices"][0, 0]).long()[valid]
    rows = out["top_valid"][0].bool().cpu()
    ref_c = out["corr_pred"][0].double().cpu()
    prog_c = torch.as_tensor(finals["final_corr_offsets"][0]).double()[valid]
    offsets = float((prog_c - ref_c[j]).abs().amax()
                    / ref_c[rows].abs().amax().clamp_min(1e-12))
    ref_p = torch.softmax(out["coexist_logits"][0].double().cpu(), -1)[:, 1]
    prog_p = torch.as_tensor(finals["final_coexist"][0]).double()[valid]
    coexist = float((prog_p - ref_p[j]).abs().amax())
    notes.append(f"corr_gap: offsets {offsets:.6g}, coexist {coexist:.6g}")
    return max(offsets, coexist)


@torch.no_grad()
def check(ctx, captures, weights, precision="float32", flops=None,
          notes=None) -> Dict[str, float]:
    notes = [] if notes is None else notes
    pool = stacks(ctx)
    _, net = C.reference(ctx.config, weights, ctx.device, precision,
                         ctx.cell.family)
    numbers = []
    for i, c in enumerate(captures):
        batch = C.on(pool[c["cur"]], ctx.device)
        with C.counting(flops if i == 0 else None):
            out = net(batch, mode="val",
                      proposals=(c["top_anchors"], c["top_valid"]))
        maps = torch.cat([out["bev_input"].flatten(0, 1),
                          out["int_bev_input"]])
        second = {k: v for k, v in out.items() if k != "corr_pred"}
        numbers.append({
            "bev_gap": float((c["maps"].float() - maps).abs().max()),
            "proposal_miss": C.proposal_miss(
                c["top_anchors"], c["top_valid"], out["own_top_anchors"],
                out["own_top_valid"]),
            "final_gap": C.final_gap(c["finals"], second, notes),
            "corr_gap": corr_gap(c["finals"], out, notes)})
        miss = C.forced_miss(c["top_valid"][0], out["forced_hit"][0])
        notes.append(f"forced_miss {miss}")
    return C.worst(numbers)


@torch.no_grad()
def control(ctx, cfg, net, device) -> List[Dict]:
    """The reference ``net`` on ``checked`` stacks of the pool drawn from
    the seed."""
    pool = stacks(ctx)
    picks = sorted(int(i) for i in ctx.rng.choice(
        len(pool), size=min(ctx.mix["checked"], len(pool)), replace=False))
    out = []
    for i in picks:
        o = net(C.on(pool[i], device), mode="val")
        out.append({"cur": i,
                    "maps": torch.cat([o["bev_input"].flatten(0, 1),
                                       o["int_bev_input"]]),
                    "top_anchors": o["top_anchors"],
                    "top_valid": o["top_valid"],
                    "finals": {key: o[key].cpu().numpy() for key in KEYS}})
    return out
