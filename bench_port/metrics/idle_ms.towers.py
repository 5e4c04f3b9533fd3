"""idle_ms.towers: device idle time inside the model's two towers
(``dodt/towers``) in each traced call, ms per call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/towers")
