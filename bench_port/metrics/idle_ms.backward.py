"""idle_ms.backward: device idle time inside the train step's gradients
(``dodt/backward``) in each traced step, ms per call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/backward")
