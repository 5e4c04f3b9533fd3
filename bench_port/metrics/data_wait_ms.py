"""data_wait_ms: host time the train loop waits for its next batch
(``dodt/data_wait``), ms per traced step (harness/spans.py)."""
from harness.spans import mean_ms


def read(r):
    return mean_ms(r, "dodt/data_wait")
