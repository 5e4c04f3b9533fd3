"""bench_torch.py's JSON line (``bench_line``) against bench.py's rule, with
fixed numbers: bench.py's keys in bench.py's order, frames/s and ms
rounded to 2 places, vs_baseline to 3, mfu to 4 (None without FLOPs or
a peak), pair_gflops to 1 (None without FLOPs). bench.py is read as
text, never imported (it imports JAX)."""
import ast
import os

import pytest

import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _bench_py_keys():
    """The keys of the dict bench.py prints, in its order."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys = [k.value for k in node.args[0].keys]
            if "metric" in keys:
                return keys
    raise AssertionError("bench.py prints no JSON dict")


def test_bench_line_keys_are_bench_py_keys_in_order():
    line = bench_torch.bench_line(0.03, 0.02, 0.025, 4e11, 989.4e12, H100)
    assert list(line) == _bench_py_keys()


# (pair_s, stream_s, stream_ego_s, flops, peak) -> the numbers bench.py's
# rounding gives
CASES = {
    "stream_faster": ((0.025938, 0.0226, 0.027204, 462.3127e9, 989.4e12),
                      {"value": 132.74, "vs_baseline": 11.644,
                       "pair_latency_ms": 25.94, "stream_keyframe_ms": 22.6,
                       "stream_keyframe_ms_ego": 27.2, "mfu": 0.018,
                       "pair_gflops": 462.3}),
    "pair_faster": ((0.0301, 0.0412, 0.04456, 462.3127e9, 989.4e12),
                    {"value": 99.67, "vs_baseline": 8.743,
                     "pair_latency_ms": 30.1, "stream_keyframe_ms": 41.2,
                     "stream_keyframe_ms_ego": 44.56, "mfu": 0.0155,
                     "pair_gflops": 462.3}),
    "no_peak": ((0.025938, 0.0226, 0.027204, 462.3127e9, None),
                {"value": 132.74, "vs_baseline": 11.644,
                 "pair_latency_ms": 25.94, "stream_keyframe_ms": 22.6,
                 "stream_keyframe_ms_ego": 27.2, "mfu": None,
                 "pair_gflops": 462.3}),
    "no_flops": ((0.025938, 0.0226, 0.027204, 0.0, 989.4e12),
                 {"value": 132.74, "vs_baseline": 11.644,
                  "pair_latency_ms": 25.94, "stream_keyframe_ms": 22.6,
                  "stream_keyframe_ms_ego": 27.2, "mfu": None,
                  "pair_gflops": None}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_line_rounds_as_bench_py(case):
    args, numbers = CASES[case]
    want = {"metric": "stream_fps_tau3", "unit": "frames/s",
            "device": H100, **numbers}
    got = bench_torch.bench_line(*args, H100)
    assert got == want
    assert list(got) == _bench_py_keys()
