"""Metrics logging, latency statistics and profiling helpers (PyTorch
port of dodt_tpu/utils/metrics.py): the JSONL metrics log, latency
statistics, a device fence, a ``torch.profiler`` trace, and the named
spans the port marks its layers with (``span``)."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named span of the port's work, ``with span("dodt/encode"):``.

    While a profiler records it is ``torch.profiler.record_function(name)``:
    a host event on the profiler's clock, so the device's kernels and idle
    gaps can be put down to the span that was open, and its parent is the
    span that contains it. Otherwise it is one shared null context: one
    flag check, no object made, nothing recorded. The flag is torch's
    process-wide one, set while any profiler runs. Every name starts with
    ``dodt/``."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NO_SPAN


class MetricsLogger:
    """Append-only JSONL metrics file + in-memory history."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history: List[Dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def log(self, step: int, **values):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) if isinstance(v, (int, float, np.floating))
                    else v for k, v in values.items()})
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


def device_sync(tree) -> None:
    """Wait until the work producing every CUDA tensor of ``tree`` (a
    tensor, or a dict, list or tuple of them, nested) has finished: one
    ``torch.cuda.synchronize`` per device they live on. CPU tensors are
    ready when returned."""
    devices = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


def latency_stats(times_s) -> Dict[str, float]:
    """Mean/median/min/max/std over per-sample latencies (reference
    print_inference_time_statistics semantics)."""
    t = np.asarray(times_s, np.float64)
    return {
        "mean_s": float(t.mean()), "median_s": float(np.median(t)),
        "min_s": float(t.min()), "max_s": float(t.max()),
        "std_s": float(t.std()), "fps": float(1.0 / t.mean()),
        "n": int(len(t)),
    }


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present), its chrome trace written to ``log_dir/trace.json`` (open in
    Perfetto or chrome://tracing). The port's ``dodt/`` spans (``span``)
    appear in it as ``user_annotation`` events on the profiler's clock,
    beside the operators, runtime calls and kernels they contain."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
