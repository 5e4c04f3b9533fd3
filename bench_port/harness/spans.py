"""The program's own spans in a traced stretch: the ``dodt/`` events that
``dodt_tpu_torch.utils.metrics.span`` records while a profiler runs,
kept among ``DeviceTrace.host`` (``user_annotation``), on the clock of
the device intervals in ``DeviceTrace.device``.

A call of a cell is its root span: the ``ROOT_SPAN`` that the mix's entry
module (``entries/<entry>.py``) declares, or for the entries older than
this file the frozen table ``ROOTS``. Only roots wholly inside the
stretch count: the stretch runs from the first start to the last end of
the events that are not ``dodt/`` spans (on the card, ``Profiled``'s
opening and closing syncs), and a root the profiler's start or stop cut
is left out. Every reading is per counted
root, and None where the trace holds no such root."""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple

from harness.cells import load_entry
from harness.trace import busy_us

PREFIX = "dodt/"
# The checkout this harness lies in, whose entries/ declare the roots.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Frozen: the roots of the three entries that predate ``ROOT_SPAN``. A
# new entry declares ``ROOT_SPAN`` in its own module and adds nothing here.
ROOTS = {"stream": "dodt/keyframe", "detect": "dodt/forward",
         "train": "dodt/train_step"}
SYNC = "Synchronize"

Interval = Tuple[float, float]


def union(spans: Sequence[Interval]) -> List[Interval]:
    """The union of [start, end] intervals as disjoint pieces in time
    order."""
    out: List[Interval] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intersect(x: Sequence[Interval], y: Sequence[Interval]
              ) -> List[Interval]:
    """The intersection of two unions (disjoint pieces in time order)."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


class Calls:
    """The counted roots of one traced stretch and what lies in them."""

    def __init__(self, trace, root: str):
        self.trace = trace
        edges = [(a, b) for a, b, _ in trace.device] + \
            [(a, b) for a, b, n in trace.host if not n.startswith(PREFIX)]
        self.roots: List[Interval] = []
        if edges:
            lo = min(a for a, _ in edges)
            hi = max(b for _, b in edges)
            self.roots = [(a, b) for a, b, n in trace.host
                          if n == root and lo <= a and b <= hi]
        self.inside = union(self.roots)
        self.busy = union([(a, b) for a, b, _ in trace.device])

    def named(self, name: str) -> List[Interval]:
        """The union of the ``name`` spans, cut to the counted roots."""
        return intersect(union([(a, b) for a, b, n in self.trace.host
                                if n == name]), self.inside)

    def idle_ms(self, name: str) -> Optional[float]:
        """Device idle time inside the ``name`` spans (their children
        included), ms per call; None where no such span lies in a root."""
        if not self.roots:
            return None
        pieces = self.named(name)
        if not pieces:
            return None
        idle = busy_us(pieces) - busy_us(intersect(pieces, self.busy))
        return idle / 1e3 / len(self.roots)

    def syncs(self) -> Optional[float]:
        """Runtime calls that block the host on the device (their names
        hold ``Synchronize``) inside the roots, per call."""
        if not self.roots:
            return None
        n = sum(1 for a, b, name in self.trace.host if SYNC in name
                and any(r0 <= a and b <= r1 for r0, r1 in self.inside))
        return n / len(self.roots)

    def mean_ms(self, name: str) -> Optional[float]:
        """Host time of the ``name`` spans inside the roots, ms per
        call; None where none lies in a root."""
        if not self.roots:
            return None
        durs = [b - a for a, b, n in self.trace.host if n == name and any(
            r0 <= a and b <= r1 for r0, r1 in self.inside)]
        if not durs:
            return None
        return sum(durs) / 1e3 / len(self.roots)


@functools.lru_cache(maxsize=None)
def root_span(entry: str, root: str) -> Optional[str]:
    """The root span of ``entries/<entry>.py`` in the checkout ``root``:
    its ``ROOT_SPAN``, else the frozen table's, else None."""
    declared = getattr(load_entry(root, entry), "ROOT_SPAN", None)
    return declared or ROOTS.get(entry)


def calls(r) -> Optional[Calls]:
    """The counted calls of a run's traced stretch, or None where the run
    has no trace or its entry no root span."""
    if r.run.trace is None:
        return None
    root = root_span(r.cell.mix.get("entry"), ROOT)
    if root is None:
        return None
    return Calls(r.run.trace, root)


def idle_ms(r, name: str) -> Optional[float]:
    c = calls(r)
    return None if c is None else c.idle_ms(name)


def syncs_per_call(r) -> Optional[float]:
    c = calls(r)
    return None if c is None else c.syncs()


def mean_ms(r, name: str) -> Optional[float]:
    c = calls(r)
    return None if c is None else c.mean_ms(name)
