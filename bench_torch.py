#!/usr/bin/env python
"""Benchmark of the PyTorch port (dodt_tpu_torch) on one CUDA card: the
counterpart of bench.py, printing ONE JSON line with bench.py's keys in
bench.py's order, rounded as bench.py rounds them (``bench_line``).

    python3 bench_torch.py

Inputs are bench.py's: cars_dt_tracking() with 65536 points and
``make_batch`` (the port's copy of bench.py's, data/synthetic_scan.py)
from seed 0; weights come from ``init_params`` with
a torch.Generator seeded 0 (random weights: the work is the real work,
the detections are not meaningful). TF32 is off, so every f32 op is a
full f32 op, as in chip_smoke.py.

Timing follows bench.py: warm-up, then 20 iterations, then one
``torch.cuda.synchronize()``; each number is the mean wall time.
  pair_latency_ms         the monolithic pair forward, DtAvodNet.forward
  stream_keyframe_ms      StreamingPredictor.push_keyframe(fetch=False)
  stream_keyframe_ms_ego  the same with bench.py's moving platform
  value                   TAU / min(pair, stream) keyframe-rate, frames/s
  mfu                     FLOPs of the pair forward over pair latency x
                          the card's dense bf16 peak; null for a card not
                          in PEAK_BF16
The FLOPs are counted by torch.utils.flop_counter.FlopCounterMode on the
all-twin forward (the conv chain as cuDNN convs): the hand-written
kernels are invisible to the counter, as Pallas kernels are to XLA's cost
analysis in bench.py.

Raises at once where torch finds no CUDA card.
"""
import dataclasses
import json
import time

import numpy as np


N_WARM, N_ITERS = 3, 20
# dense bf16 tensor-core peak by card name (NVIDIA data sheets)
PEAK_BF16 = {"H100 80GB HBM3": 989.4e12, "H100 PCIe": 756e12,
             "H100 NVL": 835e12}


def peak_flops(name: str):
    for key, peak in PEAK_BF16.items():
        if key in name:
            return peak
    return None


def mean_seconds(fn):
    """bench.py's methodology: warm up, queue N_ITERS calls, sync once."""
    import torch
    for _ in range(N_WARM):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_ITERS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / N_ITERS


def bench_line(pair_s, stream_s, stream_ego_s, flops, peak, device):
    """bench.py's JSON line, its keys in its order, each number rounded as
    bench.py rounds it: frames/s and ms to 2 places, vs_baseline to 3,
    mfu to 4 (None without FLOPs or a peak), pair_gflops to 1 (None
    without FLOPs)."""
    from dodt_tpu_torch.data.synthetic_scan import BASELINE_FPS, TAU
    fps = TAU / min(pair_s, stream_s)
    mfu = flops / (pair_s * peak) if flops > 0 and peak else None
    return {
        "metric": "stream_fps_tau3",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "pair_latency_ms": round(pair_s * 1000, 2),
        "stream_keyframe_ms": round(stream_s * 1000, 2),
        "stream_keyframe_ms_ego": round(stream_ego_s * 1000, 2),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "pair_gflops": round(flops / 1e9, 1) if flops else None,
        "device": device,
    }


def main():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from dodt_tpu_torch.config import cars_dt_tracking
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    from dodt_tpu_torch.runtime.predictor import StreamingPredictor

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py needs a CUDA card; torch finds "
                           "none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    cfg = cars_dt_tracking()
    cfg.dataset.max_points = 65536
    model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    host = make_batch(cfg, np.random.RandomState(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}

    pair_s = mean_seconds(lambda: model(batch))

    pred = StreamingPredictor(model)
    frame = {"points": host["points"][:, 0],
             "points_valid": host["points_valid"][:, 0],
             "image": host["image"][:, 0],
             "ground_plane": host["ground_plane"], "p2": host["p2"],
             "orig_image_shape": host["orig_image_shape"]}
    pred.push_keyframe(frame, fetch=False)
    stream_s = mean_seconds(lambda: pred.push_keyframe(frame, fetch=False))
    th = np.radians(0.5)                   # bench.py's moving platform
    ego = (np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                    np.float32), np.array([0.05, 3.6], np.float32))
    stream_ego_s = mean_seconds(
        lambda: pred.push_keyframe(frame, fetch=False, ego_to_prev=ego))

    cfg_x = cars_dt_tracking()
    cfg_x.dataset.max_points = cfg.dataset.max_points
    for name in ("bev_extractor", "img_extractor"):
        setattr(cfg_x.model, name, dataclasses.replace(
            getattr(cfg_x.model, name), fused_interior=()))
    model_x = DtAvodNet(cfg_x, DEFAULT_CAR_CLUSTERS).to(dev).eval()
    model_x.load_state_dict(model.state_dict())
    with FlopCounterMode(display=False) as counter:
        model_x(batch)
    flops = float(counter.get_total_flops())
    name = torch.cuda.get_device_name(0)
    peak = peak_flops(name)

    print(json.dumps(bench_line(pair_s, stream_s, stream_ego_s, flops, peak,
                                name)))


if __name__ == "__main__":
    main()
