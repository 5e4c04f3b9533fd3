"""idle_ms.optimizer: device idle time inside the train step's optimiser
update, parameter add and EMA (``dodt/optimizer``) in each traced step,
ms per call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/optimizer")
