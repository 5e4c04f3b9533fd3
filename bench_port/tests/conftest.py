"""Fixtures of the benchmark's CPU tests: a copy of the benchmark under a
temporary root, with the repository's program beside it and every
configuration cut to ``unittest_pipeline()`` sizes (the harness, the
reference and the program's plain path on the CPU)."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch finds none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def small_mix(mix):
    mix = dict(mix, valid_points=3000, pool=4, car_points=50, cars=[1, 2],
               checked=2)
    for k in ("warmup", "span_calls", "trace_calls"):
        if k in mix:
            mix[k] = 4
    for k, v in (("warmup_steps", 3), ("span_steps", 2), ("trace_steps", 2)):
        if k in mix:
            mix[k] = v
    if "mesh" in mix:
        # two gloo ranks on the CPU, one couple each
        mix.update(mesh=[2, 1], batch_size=2)
    return mix


def make_tiny_root(path):
    """A checkout at ``path``: BENCHMARK.json and bench_port/ copied, the
    program linked, configurations and mixes cut to test sizes."""
    from dodt_tpu_torch.config import unittest_pipeline
    shutil.copytree(BENCH, os.path.join(path, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "dodt_tpu_torch"),
               os.path.join(path, "dodt_tpu_torch"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), path)
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for c in bench["configs"]:
        p = os.path.join(path, c["file"])
        cfg = json.load(open(p))
        small = json.loads(unittest_pipeline().to_json())
        small["model"]["model_name"] = cfg["pipeline"]["model"]["model_name"]
        cfg["pipeline"] = small
        json.dump(cfg, open(p, "w"))
    traffic = os.path.join(path, "bench_port", "traffic")
    for name in os.listdir(traffic):
        p = os.path.join(traffic, name)
        json.dump(small_mix(json.load(open(p))), open(p, "w"))
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


# The data-parallel train cell's entries of BENCHMARK.json: its files
# (entries/train_dp4.py, traffic/train_dp4.json,
# limits/cars_dt.train_dp4.json, metrics/all_reduce_ms.py and
# metrics/mfu.train_dp4.py) are in the benchmark, the cell is not yet
# (PERF.md, Open questions).
DP4 = "cars_dt.train_dp4"
DP4_CELL = {"name": DP4, "config": "cars_dt", "traffic": "train_dp4",
            "chips": 4,
            "why": "Trainer.train on a (4, 1) mesh over NCCL, 1 couple a "
                   "rank, global batch 4, Adam: the flat all-reduce of "
                   "25.1M gradients a step, the ranks' lock-step"}
DP4_METRICS = ("train_samples_per_s", "device_idle.train", "idle_ms.forward",
               "idle_ms.backward", "idle_ms.optimizer", "syncs_per_step",
               "data_wait_ms")
DP4_NEW = [{"name": "all_reduce_ms", "unit": "ms", "better": "lower",
            "source": "device_trace",
            "layer": "parallel/mesh reduce_over_data",
            "moves": "train_samples_per_s", "workloads": [DP4]},
           {"name": "mfu.train_dp4", "unit": "%", "better": "higher",
            "source": "host_clock", "layer": "device",
            "moves": "train_samples_per_s", "workloads": [DP4]}]


@pytest.fixture
def dp4_root(tiny_root):
    """The tiny checkout with the data-parallel train cell's entries
    added to its BENCHMARK.json."""
    path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["workloads"].append(DP4_CELL)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in DP4_METRICS:
            m["workloads"].append(DP4)
    bench["per_layer"] += DP4_NEW
    json.dump(bench, open(path, "w"))
    return tiny_root


def run_cell(root, cell, seed=3000000011, trace=0, seconds=1.0):
    """One CPU run of ``cell`` under ``root``: (result, stderr lines)."""
    import run
    return run.measure(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)], device="cpu",
                       root=root)
