"""idle_ms.forward: device idle time inside the train step's forward
(``dodt/forward``) in each traced step, ms per call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/forward")
