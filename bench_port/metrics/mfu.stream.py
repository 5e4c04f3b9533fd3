"""mfu.stream: the reference's FLOPs of one keyframe (FlopCounterMode)
over the window's mean keyframe time x the dense bf16 peak."""
from harness.roofline import mfu


def read(r):
    return mfu(r)
