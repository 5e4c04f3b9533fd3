"""The harness on the CPU: seeded inputs, the statistics, the trace's
busy union and idle gaps, the roofline arithmetic, and a configuration,
mix and metric added as files only."""
import json
import os

import numpy as np
import pytest

from conftest import run_cell
from harness import inputs, roofline, stats
from harness.trace import DeviceTrace, busy_us, idle_gaps

MIX = {"pool": 3, "valid_points": 2000, "cars": [2, 4], "car_points": 40}


def same(a, b):
    return all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
               for k in a)


@pytest.mark.parametrize("pool", ["frames", "couples"])
def test_inputs_repeat_for_a_seed_and_differ_between_seeds(pool):
    def make(seed):
        if pool == "frames":
            return inputs.frame_pool(seed, MIX, 2048, (30, 40))
        return inputs.couple_pool(seed, MIX, 2048, (30, 40), 8)
    big = 2 ** 31 + 12345
    a, b, c = make(big), make(big), make(big + 1)
    assert all(same(x, y) for x, y in zip(a, b))
    assert not any(same(x, y) for x, y in zip(a, c))
    # the sizes do not depend on the seed
    assert all(x[k].shape == y[k].shape for x, y in zip(a, c) for k in x)
    assert all(int(x["points_valid"].sum()) == MIX["valid_points"]
               * (x["points_valid"].size // 2048) for x in a)


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    import torch
    from harness.weights import make_weights
    shapes = [("a.weight", torch.Size([8, 4, 3, 3])), ("a.bias", (8,)),
              ("x.GroupNorm_0.weight", (8,)),
              ("rpn_reg.out.weight", torch.Size([6, 16])),
              ("rpn_reg.out.bias", (6,))]
    dev = torch.device("cpu")
    w1, w2, w3 = (make_weights(shapes, s, dev, {"rpn_reg.out.weight": 0.01})
                  for s in (2 ** 31 + 5, 2 ** 31 + 5, 2 ** 31 + 6))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert float(w1["a.bias"].abs().max()) == 0
    assert torch.equal(w1["x.GroupNorm_0.weight"], torch.ones(8))
    # LeCun normal cut at 2 sigma, then rpn_reg's output scaled
    std = (1 / 36) ** 0.5 / 0.8796256610342398
    assert float(w1["a.weight"].abs().max()) <= 2 * std + 1e-6
    assert float(w1["rpn_reg.out.weight"].abs().max()) <= \
        0.01 * 2 * (1 / 16) ** 0.5 / 0.8796256610342398 + 1e-6


def test_percentile_is_over_every_request():
    lat = [1.0] * 95 + [100.0] * 5
    assert stats.percentile(lat, 95) == pytest.approx(
        np.percentile(lat, 95))
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    # one slow request in twenty moves the 95th percentile
    assert stats.percentile([1.0] * 19 + [50.0], 95) > 1.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(200, 20.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    import statistics
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 15), (20, 25), (21, 22), (30, 31)]
    assert busy_us(spans) == 10 + 5 + 5 + 1
    assert idle_gaps(spans) == [(15, 20), (25, 30)]
    assert busy_us([]) == 0


def test_trace_reduction_names_gaps_by_the_host_op():
    ev = [{"cat": "kernel", "ts": 0, "dur": 10,
           "name": "conv3x3_bias_relu_kernel"},
          {"cat": "kernel", "ts": 5, "dur": 10, "name": "k2"},
          {"cat": "gpu_memcpy", "ts": 40, "dur": 5, "name": "Memcpy DtoH"},
          {"cat": "cpu_op", "ts": 14, "dur": 30, "name": "aten::nonzero"},
          {"cat": "cpu_op", "ts": 0, "dur": 100, "name": "outer"}]
    t = DeviceTrace(ev, 50e-6)
    assert t.busy_s == pytest.approx(20e-6)
    assert t.kernel("conv3x3_bias_relu") == (pytest.approx(10e-6), 1)
    assert t.top_ops()[0][0] in ("conv3x3_bias_relu_kernel", "k2")
    assert t.top_gaps() == [["aten::nonzero", pytest.approx(25e-6)]]


def test_b1_bound_counts_2_9_px_sum_ci_co():
    cfg = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "configs",
        "cars_dt.json")))
    model = cfg["pipeline"]["model"]
    launches = roofline.b1_launches(model, (700, 800), (360, 1200))
    assert launches == [(88, 100, 128, 256), (88, 100, 256, 256),
                        (88, 100, 256, 256), (45, 150, 128, 256),
                        (45, 150, 256, 256), (45, 150, 256, 256)]
    flops = sum(roofline.conv3x3_flops(*s) for s in launches)
    sum_cc = 128 * 256 + 2 * 256 * 256
    assert flops == 2 * 9 * (88 * 100 + 45 * 150) * sum_cc
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    # operations bound every stage: 0.0464 ms in all at 989 TFLOP/s
    assert roofline.b1_bound_s(launches, peak) == pytest.approx(
        flops / 989e12)
    assert roofline.conv3x3_bytes(1, 1, 2, 3) == 2 * (2 + 3 + 54) + 12


def test_b3_bound_at_the_pair_stage_shapes():
    cfg = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "configs",
        "cars_dt.json")))
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    flops = 350 * 400 * 121 * (2 * 32 + 2)
    assert roofline.b3_bound_s(cfg["pipeline"]["model"], (700, 800), peak) \
        == pytest.approx(max(flops / 67e12, 4 * (2 * 350 * 400 * 32 + 121
                                                 + 350 * 400) / 3.35e12))
    assert roofline.peaks("Tesla T4") is None


def test_a_configuration_mix_and_metric_added_as_files_run(tiny_root):
    """A new cell of a new configuration and mix, with a new metric, is
    listed and run by the harness with no edit to an existing file."""
    bench_dir = os.path.join(tiny_root, "bench_port")
    before = {}
    for d, _, files in os.walk(bench_dir):
        for f in files:
            p = os.path.join(d, f)
            before[p] = open(p, "rb").read()
    cfg = json.load(open(os.path.join(bench_dir, "configs", "cars_dt.json")))
    cfg["name"] = "cars_dt_wide"
    cfg["pipeline"]["dataset"]["kitti_utils"]["anchor_strides"] = [1.0, 1.0]
    json.dump(cfg, open(os.path.join(bench_dir, "configs",
                                     "cars_dt_wide.json"), "w"))
    mix = json.load(open(os.path.join(bench_dir, "traffic", "stream.json")))
    mix["ego"] = {"yaw_deg": 1.0, "translate_xz": [0.0, 1.0]}
    json.dump(mix, open(os.path.join(bench_dir, "traffic",
                                     "stream_slow.json"), "w"))
    json.dump({"feat_gap": 0.5}, open(os.path.join(
        bench_dir, "limits", "cars_dt_wide.stream_slow.json"), "w"))
    with open(os.path.join(bench_dir, "metrics", "keyframes_seen.py"),
              "w") as f:
        f.write("def read(r):\n    return float(r.run.calls)\n")
    # what a later PR would add to BENCHMARK.json: entries, no edits
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    bench["configs"].append({"name": "cars_dt_wide", "source": "x",
                             "file": "bench_port/configs/cars_dt_wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "cars_dt_wide.stream_slow",
                               "config": "cars_dt_wide",
                               "traffic": "stream_slow", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "keyframes_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "keyframes_per_s",
                               "workloads": ["cars_dt_wide.stream_slow"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cars_dt.stream" in m["workloads"]:
            m["workloads"].append("cars_dt_wide.stream_slow")
    json.dump(bench, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))
    res, _ = run_cell(tiny_root, "cars_dt_wide.stream_slow", trace=1)
    assert res["correct"]
    assert res["metrics"]["keyframes_seen"]["value"] == res["attempted"]
    res, _ = run_cell(tiny_root, "cars_dt_wide.stream_slow", trace=0)
    assert set(res["metrics"]) == {"keyframe_p95_ms", "keyframes_per_s",
                                   "setup_s"}
    assert all(open(p, "rb").read() == b for p, b in before.items())


NEW_ENTRY = '''"""Entry encode_only: the model's encode_frame on the pool in turn."""
import time

import torch

from harness import check as C
from harness.program import Run, Sampler


def drive(ctx):
    frames, run = ctx.frames(), Run()
    ctx.setup_done()
    sampler = Sampler(ctx.mix["checked"], ctx.rng)
    t0, i = time.perf_counter(), 0
    while True:
        slot = sampler.slot(i)
        ts = time.perf_counter()
        state = ctx.model.encode_frame(C.on(frames[i % len(frames)],
                                            ctx.device))
        te = time.perf_counter()
        run.latencies.append(te - ts)
        if slot is not None:
            sampler.kept[slot] = {"cur": i % len(frames),
                                  "bev_feats": state["bev_feats"]}
        i += 1
        if te - t0 >= ctx.seconds:
            break
    run.window_s, run.calls = te - t0, i
    run.captures = sampler.items()
    ctx.window_done()
    return run


@torch.no_grad()
def check(ctx, captures, weights, precision="float32", flops=None,
          notes=None):
    _, net = C.reference(ctx.config, weights, ctx.device, precision)
    return C.worst([{"feat_gap": C.rel_gap(c["bev_feats"], net.encode_frame(
        C.on(ctx.frames()[c["cur"]], ctx.device))["bev_feats"])}
        for c in captures])
'''


def test_a_mix_with_a_new_entry_added_as_files_runs(tiny_root):
    """A mix that drives the program through an entry of its own: the
    entry, the mix, the limits and the cell are new files and entries,
    and no existing file changes."""
    bench_dir = os.path.join(tiny_root, "bench_port")
    before = {}
    for d, _, files in os.walk(bench_dir):
        for f in files:
            p = os.path.join(d, f)
            before[p] = open(p, "rb").read()
    with open(os.path.join(bench_dir, "entries", "encode_only.py"),
              "w") as f:
        f.write(NEW_ENTRY)
    mix = {"entry": "encode_only", "pool": 3, "valid_points": 2000,
           "cars": [1, 2], "car_points": 40, "checked": 2}
    json.dump(mix, open(os.path.join(bench_dir, "traffic",
                                     "encode_only.json"), "w"))
    json.dump({"feat_gap": 1e-4}, open(os.path.join(
        bench_dir, "limits", "cars_dt.encode_only.json"), "w"))
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "cars_dt.encode_only",
                               "config": "cars_dt", "traffic": "encode_only",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "keyframes_per_s":
            m["workloads"].append("cars_dt.encode_only")
    json.dump(bench, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))
    res, err = run_cell(tiny_root, "cars_dt.encode_only")
    assert res["correct"], err
    assert set(res["metrics"]) == {"keyframes_per_s", "setup_s"}
    assert res["attempted"] >= 1
    assert res["metrics"]["keyframes_per_s"]["value"] > 0
    assert all(open(p, "rb").read() == b for p, b in before.items())


def test_train_reference_takes_the_programs_candidates(tiny_root):
    """On the two-pass RPN the reference ranks the candidates in the
    program's order, read from the program's step: none is missing."""
    p = os.path.join(tiny_root, "bench_port", "configs", "cars_dt.json")
    cfg = json.load(open(p))
    cfg["pipeline"]["model"]["rpn"]["fusion_top_k"] = 32
    json.dump(cfg, open(p, "w"))
    res, err = run_cell(tiny_root, "cars_dt.train")
    assert res["correct"], err
    steps = [e for e in err if "interest_miss" in e]
    assert len(steps) == 5, err
    assert all("interest_miss 0.0;" in e for e in steps), steps
