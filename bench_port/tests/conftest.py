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


def run_cell(root, cell, seed=3000000011, trace=0, seconds=1.0):
    """One CPU run of ``cell`` under ``root``: (result, stderr lines)."""
    import run
    return run.measure(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)], device="cpu",
                       root=root)
