"""keyframes_per_s: every keyframe completed over the whole window
(host clock)."""
from harness.stats import rate


def read(r):
    return rate(r.run.calls, r.run.window_s)
