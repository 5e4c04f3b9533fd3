"""train_samples_per_s: the samples of every train step of the window
over the whole window, the device synced at both ends (host clock)."""
from harness.stats import rate


def read(r):
    return rate(r.run.calls * r.run.samples_per_call, r.run.window_s)
