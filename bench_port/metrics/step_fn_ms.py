"""step_fn_ms: mean ms of the synced span around the Trainer's
step function (forward, losses, backward, optimiser update); the loop's
own time per step (prefetch wait, loss fetch) shows against it."""


def read(r):
    return r.mean_span_ms("step_fn")
