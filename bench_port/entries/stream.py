"""Entry ``stream``: one stream, closed loop.
``StreamingPredictor.push_keyframe(frame, fetch=True, ego_to_prev=ego)``
on the frame pool in turn, with the mix's ego motion; a keyframe's
latency runs from host arrays in to detections on the host.

The comparison, on the keyframes the reservoir keeps: the keyframe's
rasterized BEV input (``bev_gap``, exact), its tower outputs
(``feat_gap``), its proposals and its predecessor's against the
reference's own NMS (``proposal_miss``), and the pair's final detections
against the reference's second stage on the program's proposals
(``final_gap``). The reference encodes both frames of the pair from the
inputs, warps the keyframe's state by the ego motion and runs the pair
stage itself (``harness/check.py``)."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import check as C
from harness import inputs
from harness.program import Run, Sampler, spy, sync
from harness.trace import trace


def ego(mix: Dict):
    return inputs.ego_motion(mix["ego"]["yaw_deg"],
                             mix["ego"]["translate_xz"])


def drive(ctx) -> Run:
    from dodt_tpu_torch.models import dt_avod
    from dodt_tpu_torch.runtime.predictor import StreamingPredictor
    mix, dev, model = ctx.mix, ctx.device, ctx.model
    pool = ctx.frames()
    pred = StreamingPredictor(model, device=dev)
    n = len(pool)
    run = Run()
    hold: Dict = {}
    spans: Dict[str, List[float]] = {}
    do_sync = sync(dev)
    motion = ego(mix)

    real_encode = model.encode_frame

    def encode(batch):
        if "span" in hold:
            do_sync()
            t0 = time.perf_counter()
        state = real_encode(batch)
        if "span" in hold:
            do_sync()
            hold["encoded_at"] = time.perf_counter()
            spans.setdefault("encode_frame", []).append(
                hold["encoded_at"] - t0)
        prev, hold["last"] = hold.get("last"), state
        if "slot" in hold:
            hold["state"], hold["prev_state"] = state, prev
        return state

    def rasterize(real):
        def wrapped(*a, **k):
            maps = real(*a, **k)
            if "slot" in hold:
                hold.setdefault("bev_input", []).append(maps.features)
            return maps
        return wrapped

    def push(k):
        return pred.push_keyframe(pool[k % n], fetch=True, ego_to_prev=motion)

    model.encode_frame = encode
    try:
        with spy(dt_avod, "bev_maps_from_points", rasterize):
            warm = mix["warmup"]
            for k in range(warm):
                push(k)
            ctx.setup_done()
            sampler = Sampler(mix["checked"], ctx.rng)
            t0 = time.perf_counter()
            i = 0
            while True:
                slot = sampler.slot(i)
                if slot is not None:
                    hold["slot"] = slot
                ts = time.perf_counter()
                out = push(warm + i)
                te = time.perf_counter()
                run.latencies.append(te - ts)
                if slot is not None:
                    sampler.kept[slot] = {
                        "prev": (warm + i - 1) % n, "cur": (warm + i) % n,
                        "state": hold.pop("state"),
                        "prev_state": hold.pop("prev_state"),
                        "bev_input": torch.stack(hold.pop("bev_input")),
                        "finals": out}
                    hold.pop("slot")
                i += 1
                if te - t0 >= ctx.seconds:
                    break
            run.window_s, run.calls = te - t0, i
            run.captures = sampler.items()
            ctx.window_done()
            if ctx.traced:
                k0 = warm + i
                hold["span"] = True
                for j in range(mix["span_calls"]):
                    push(k0 + j)
                    spans.setdefault("pair_stage", []).append(
                        time.perf_counter() - hold["encoded_at"])
                hold.pop("span")
                k0 += mix["span_calls"]
                run.trace = trace(lambda: [push(k0 + j) for j in
                                           range(mix["trace_calls"])],
                                  do_sync)
    finally:
        del model.encode_frame
    run.spans = spans
    return run


@torch.no_grad()
def check(ctx, captures, weights, precision="float32", flops=None,
          notes=None) -> Dict[str, float]:
    from reference import model as ref_model
    notes = [] if notes is None else notes
    device, frames = ctx.device, ctx.frames()
    cfg, net = C.reference(ctx.config, weights, device, precision,
                           ctx.cell.family)
    a2, b2 = (torch.as_tensor(np.asarray(v, np.float32), device=device)
              for v in ego(ctx.mix))
    numbers = []
    for i, c in enumerate(captures):
        encs = []
        for key, state in (("prev", c["prev_state"]), ("cur", c["state"])):
            f = C.on(frames[c[key]], device)
            with C.counting(flops if i == 0 and key == "cur" else None):
                encs.append(net._encode(
                    f["points"], f["points_valid"],
                    f["ground_plane"].float(), f["image"], f["p2"],
                    f["orig_image_shape"].float(),
                    ref_model._TrainCtx(forced=(state["top_anchors"],
                                                state["top_valid"]))))
        states = [{**{k: e[k] for k in ("bev_feats", "img_feats",
                                        "top_anchors", "top_valid")},
                   "ground_plane": C.on(frames[c[key]],
                                        device)["ground_plane"]}
                  for e, key in zip(encs, ("prev", "cur"))]
        with C.counting(flops if i == 0 else None):
            warped = ref_model.warp_state(cfg, states[1], a2, b2)
            pair = [states[0], warped]
            first = C.on(frames[c["prev"]], device)
            second = net._second_stage(
                *(torch.stack([s[k] for s in pair], 1) for k in (
                    "bev_feats", "img_feats", "top_anchors", "top_valid")),
                first["ground_plane"], first["p2"],
                first["orig_image_shape"].float(), 0.0)
        prog, enc = c["state"], encs[1]
        numbers.append({
            "bev_gap": float((c["bev_input"].float()
                              - enc["bev_input"]).abs().max()),
            "feat_gap": max(C.rel_gap(prog["bev_feats"], enc["bev_feats"]),
                            C.rel_gap(prog["img_feats"], enc["img_feats"])),
            "proposal_miss": max(C.proposal_miss(
                s["top_anchors"], s["top_valid"], e["own_top_anchors"],
                e["own_top_valid"])
                for s, e in zip((c["prev_state"], prog), encs)),
            "final_gap": C.final_gap(c["finals"], second, notes)})
        notes.append("forced_miss " + " ".join(
            str(C.forced_miss(s["top_valid"], e["forced_hit"]))
            for s, e in zip((c["prev_state"], prog), encs)))
    return C.worst(numbers)


@torch.no_grad()
def control(ctx, cfg, net, device) -> List[Dict]:
    """The reference ``net`` on ``checked`` keyframes of the pool drawn
    from the seed, each after its predecessor."""
    from reference import model as ref_model
    frames = ctx.frames()
    n = len(frames)
    a2, b2 = (torch.as_tensor(np.asarray(v, np.float32), device=device)
              for v in ego(ctx.mix))
    picks = sorted(int(i) for i in ctx.rng.choice(
        n, size=min(ctx.mix["checked"], n), replace=False))
    out = []
    for i in picks:
        f = C.on(frames[i], device)
        prev = C.on(frames[(i - 1) % n], device)
        enc = net._encode(f["points"], f["points_valid"],
                          f["ground_plane"].float(), f["image"], f["p2"],
                          f["orig_image_shape"].float())
        state = {**{key: enc[key] for key in (
            "bev_feats", "img_feats", "top_anchors", "top_valid")},
            "ground_plane": f["ground_plane"], "p2": f["p2"],
            "orig_image_shape": f["orig_image_shape"]}
        prev_state = net.encode_frame(prev)
        pair = net.pair_stage(prev_state,
                              ref_model.warp_state(cfg, state, a2, b2))
        out.append({"prev": (i - 1) % n, "cur": i, "state": state,
                    "prev_state": prev_state,
                    "bev_input": enc["bev_input"],
                    "finals": {key: v.cpu().numpy()
                               for key, v in pair.items()}})
    return out
