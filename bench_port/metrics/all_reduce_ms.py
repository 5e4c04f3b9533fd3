"""all_reduce_ms: device ms of the NCCL kernels (their names hold
``nccl``: the gradient all-reduce, and the time it waits for the other
ranks) per traced train step, in rank 0's trace; None where the trace
holds none (a single process, gloo)."""


def read(r):
    tr = r.run.trace
    if tr is None:
        return None
    secs, launches = tr.kernel("nccl")
    if not launches:
        return None
    return 1e3 * secs / r.cell.mix["trace_steps"]
