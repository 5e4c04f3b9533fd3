"""Metrics logging and latency statistics (the port's copy of the host
half of dodt_tpu/utils/metrics.py: ``MetricsLogger`` and
``latency_stats``; the JAX device-sync and profiler hooks are not
copied)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


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
