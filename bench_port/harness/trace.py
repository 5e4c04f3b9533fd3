"""A ``torch.profiler`` trace of a stretch of the run, reduced to the
device's busy time (the union of kernel, memcpy and memset intervals,
``probes/keyframe_trace.py``'s ``busy_ms``), time and launches by kernel
name, the device operations that took most time, and the idle gaps by
what the host was doing."""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def busy_us(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end] intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_gaps(spans: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union's pieces, in time order."""
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


class DeviceTrace:
    """Device and host events of one traced stretch (times in us) and
    the stretch's length by the host's clock, ``window_s``."""

    def __init__(self, events: List[Dict], window_s: float):
        self.window_s = window_s
        self.device = [(e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events
                       if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.host = [(e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events
                     if e.get("cat") in HOST_CATS and "dur" in e]

    @property
    def busy_s(self) -> float:
        return busy_us([(a, b) for a, b, _ in self.device]) / 1e6

    def kernel(self, name_part: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``name_part``."""
        hits = [b - a for a, b, n in self.device if name_part in n]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10, longest: int = 500) -> List[List]:
        """The ``longest`` idle gaps' seconds summed by the innermost host
        event running at each gap's middle ("host" where none is)."""
        import numpy as np
        gaps = sorted(idle_gaps([(s, e) for s, e, _ in self.device]),
                      key=lambda g: g[0] - g[1])[:longest]
        starts = np.array([s for s, _, _ in self.host], np.float64)
        ends = np.array([e for _, e, _ in self.host], np.float64)
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            hit = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (self.host[hit[np.argmin(ends[hit] - starts[hit])]][2]
                    if len(hit) else "host")
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Profiled:
    """Profiles (CPU and CUDA activities) from ``__enter__`` to
    ``__exit__``, synchronised at both ends, and leaves the reduced trace
    in ``result``. The chrome trace goes through a file under TMPDIR,
    which is removed."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.result = None

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.result = DeviceTrace(events, window_s)
        return False


def trace(calls: Callable[[], None], sync: Callable[[], None]
          ) -> DeviceTrace:
    """The reduced trace of ``calls()``."""
    with Profiled(sync) as p:
        calls()
    return p.result
