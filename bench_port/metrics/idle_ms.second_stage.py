"""idle_ms.second_stage: device idle time inside the model's second stage:
crops, trunk, heads, decode, final NMS and correlation
(``dodt/second_stage``) in each traced call, ms per call
(harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/second_stage")
