"""idle_ms.rpn: device idle time inside the model's RPN: bottlenecks, ROIs,
fusion, heads, prefilter and NMS (``dodt/rpn``) in each traced call, ms
per call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/rpn")
