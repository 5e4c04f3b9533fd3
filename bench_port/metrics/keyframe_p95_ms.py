"""keyframe_p95_ms: the 95th percentile, in ms, over every keyframe of
the window, from host arrays in to detections on the host (host
clock)."""
from harness.stats import percentile


def read(r):
    return 1e3 * percentile(r.run.latencies, 95)
