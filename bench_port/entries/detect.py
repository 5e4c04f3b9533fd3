"""Entry ``detect``: closed loop. ``DtAvodNet.forward(batch,
mode="val")`` on the frame pool in turn, one frame a call, with the
detections fetched to the host; a call's latency runs from host arrays
in to detections on the host.

The comparison, on the calls the reservoir keeps: the rasterized BEV
input (``bev_gap``, exact), the proposals against the reference's own
NMS (``proposal_miss``), and the final detections against the
reference's second stage on the program's proposals (``final_gap``)."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from harness import check as C
from harness.program import Run, Sampler, sync
from harness.trace import trace

DETECTION_KEYS = ("final_boxes_3d", "final_orientations",
                  "final_cls_softmax", "final_scores", "final_valid")


def one_frame(frame: Dict) -> Dict:
    """A frame of the pool as a batch of one sample of one frame."""
    return {k: (v[:, None] if k in ("points", "points_valid", "image")
                else v) for k, v in frame.items()}


def drive(ctx) -> Run:
    mix, dev, model = ctx.mix, ctx.device, ctx.model
    frames = [one_frame(f) for f in ctx.frames()]
    n = len(frames)
    run = Run()
    do_sync = sync(dev)

    def call(k):
        batch = {key: torch.as_tensor(v, device=dev)
                 for key, v in frames[k % n].items()}
        out = model(batch, mode="val")
        return out, {key: out[key].cpu().numpy() for key in DETECTION_KEYS}

    warm = mix["warmup"]
    for k in range(warm):
        call(k)
    ctx.setup_done()
    sampler = Sampler(mix["checked"], ctx.rng)
    t0 = time.perf_counter()
    i = 0
    while True:
        slot = sampler.slot(i)
        ts = time.perf_counter()
        out, host = call(warm + i)
        te = time.perf_counter()
        run.latencies.append(te - ts)
        if slot is not None:
            sampler.kept[slot] = {
                "cur": (warm + i) % n, "bev_input": out["bev_input"],
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


@torch.no_grad()
def check(ctx, captures, weights, precision="float32", flops=None,
          notes=None) -> Dict[str, float]:
    notes = [] if notes is None else notes
    frames = ctx.frames()
    _, net = C.reference(ctx.config, weights, ctx.device, precision,
                         ctx.cell.family)
    numbers = []
    for i, c in enumerate(captures):
        batch = C.on(one_frame(frames[c["cur"]]), ctx.device)
        with C.counting(flops if i == 0 else None):
            out = net(batch, mode="val",
                      proposals=(c["top_anchors"], c["top_valid"]))
        numbers.append({
            "bev_gap": float((c["bev_input"].float()
                              - out["bev_input"]).abs().max()),
            "proposal_miss": C.proposal_miss(
                c["top_anchors"][0], c["top_valid"][0],
                out["own_top_anchors"][0], out["own_top_valid"][0]),
            "final_gap": C.final_gap(c["finals"], out, notes)})
        notes.append(f"forced_miss "
                     f"{C.forced_miss(c['top_valid'][0], out['forced_hit'][0])}")
    return C.worst(numbers)


@torch.no_grad()
def control(ctx, cfg, net, device) -> List[Dict]:
    """The reference ``net`` on ``checked`` frames of the pool drawn from
    the seed."""
    frames = ctx.frames()
    picks = sorted(int(i) for i in ctx.rng.choice(
        len(frames), size=min(ctx.mix["checked"], len(frames)),
        replace=False))
    out = []
    for i in picks:
        o = net(C.on(one_frame(frames[i]), device), mode="val")
        out.append({"cur": i, "bev_input": o["bev_input"],
                    "top_anchors": o["top_anchors"],
                    "top_valid": o["top_valid"],
                    "finals": {key: o[key].cpu().numpy()
                               for key in DETECTION_KEYS}})
    return out
