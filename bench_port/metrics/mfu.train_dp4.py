"""mfu.train_dp4: the reference's FLOPs of one global train step
(forward, backward, update of the whole global batch; FlopCounterMode)
over the window's mean step time x the cell's cards x the dense bf16
peak of one card."""
from harness.roofline import peaks


def read(r):
    table = peaks(r.device_kind)
    if table is None or not r.flops:
        return None
    return 100.0 * r.flops / (r.mean_call_s * r.cell.chips * table["bf16"])
