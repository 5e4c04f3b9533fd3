"""Statistics the benchmark reports: a percentile over every request,
a rate over the whole window, and the spread it sets bounds from."""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all values, linear between order
    statistics (numpy's default)."""
    if not len(values):
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: int, seconds: float) -> float:
    """count over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median with Python's quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
