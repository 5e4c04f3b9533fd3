"""setup_s: seconds from the process's start to the first timed call:
import, the kernel library, weights made on the card, the pools and the
warm-up of the cell's own shapes (host clock)."""


def read(r):
    return r.setup_s
