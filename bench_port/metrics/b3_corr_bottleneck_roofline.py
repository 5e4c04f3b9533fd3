"""b3_corr_bottleneck_roofline: kernel B3's bound time (f32 operations
or bytes at the pair stage's shapes) over its device time in the
trace."""
from harness.roofline import b3_bound_s, bev_shape, peaks, share_of_bound

KERNEL = "corr_bottleneck_kernel"


def read(r):
    table = peaks(r.device_kind)
    if table is None:
        return None
    return share_of_bound(r, KERNEL, b3_bound_s(
        r.pipeline["model"], bev_shape(r.pipeline), table))
