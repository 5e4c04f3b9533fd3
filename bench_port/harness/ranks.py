"""An entry whose window runs on several cards: its ``rank(*args)`` runs
in each rank of one process group, started by the port's own launcher
(``dodt_tpu_torch.parallel.launch.spawn``: fresh processes, rank r on
card r under NCCL, one intra-op thread each, a rendezvous file under
TMPDIR). The launcher pickles the function it starts by its import path,
so the ranks start ``entry_rank``, which finds the entry by name in the
checkout, as ``harness.cells.load_entry`` does in the run's own process;
a new multi-card entry adds files only."""
from __future__ import annotations

from typing import Any, List


def entry_rank(root: str, entry: str, *args) -> Any:
    from harness.cells import load_entry
    return load_entry(root, entry).rank(*args)


def spawn(root: str, entry: str, world: int, *args, backend: str,
          timeout_s: float) -> List[Any]:
    """``entries/<entry>.py``'s ``rank(*args)`` on ranks 0..world-1;
    each rank's result, in rank order."""
    from dodt_tpu_torch.parallel import launch
    return launch.spawn(entry_rank, world, root, entry, *args,
                        backend=backend, timeout_s=timeout_s)
