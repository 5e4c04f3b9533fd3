"""b1_conv_chain_roofline: kernel B1's bound time (bf16 operations or
bytes, per launch at the shapes of the configuration's fused blocks)
over its device time in the trace. The launches of one frame are those
of harness.roofline.b1_launches; a trace whose count is no multiple of
them is not read."""
from harness.roofline import (b1_bound_s, b1_launches, bev_shape, peaks,
                              share_of_bound)

KERNEL = "conv3x3_bias_relu_kernel"


def read(r):
    table = peaks(r.device_kind)
    if table is None or r.run.trace is None:
        return None
    d = r.pipeline["dataset"]
    per_frame = b1_launches(r.pipeline["model"], bev_shape(r.pipeline),
                            tuple(d["image_shape"]))
    _, launches = r.run.trace.kernel(KERNEL)
    if not per_frame or launches % len(per_frame):
        return None
    return share_of_bound(r, KERNEL, b1_bound_s(per_frame, table)
                          / len(per_frame))
