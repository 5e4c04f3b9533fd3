"""idle_ms.stack_corr: device idle time inside the Stack model's
correlation head over the first and last frames' ROIs
(``dodt/stack_corr``), in each traced call, ms per call
(harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/stack_corr")
