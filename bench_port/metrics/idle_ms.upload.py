"""idle_ms.upload: device idle time inside the predictor's upload of the
frame's host arrays (``dodt/upload``) in each traced keyframe, ms per
call (harness/spans.py)."""
from harness.spans import idle_ms


def read(r):
    return idle_ms(r, "dodt/upload")
