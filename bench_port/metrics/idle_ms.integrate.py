"""idle_ms.integrate: device idle time inside the Stack model's
rasterization of the integrated cloud, every frame's points at once
(``dodt/integrate``), in each traced call, ms per call
(harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/integrate")
