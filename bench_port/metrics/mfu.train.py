"""mfu.train: the reference's FLOPs of one train step (forward,
backward, update; FlopCounterMode) over the window's mean step time x
the dense bf16 peak, per chip."""
from harness.roofline import mfu


def read(r):
    return mfu(r)
