"""idle_ms.rasterize: device idle time inside the model's rasterization,
anchor tiling and empty-anchor mask (``dodt/rasterize``) in each traced
call, ms per call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/rasterize")
