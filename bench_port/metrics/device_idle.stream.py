"""device_idle.stream: the share of the traced stretch of keyframes in
which no kernel, memcpy or memset ran on the card."""
from harness.roofline import idle_share


def read(r):
    return idle_share(r)
