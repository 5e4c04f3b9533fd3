"""What every entry shares: the program (``dodt_tpu_torch``, the system
under test) built from a configuration file, the run an entry hands
back, the reservoir that picks the window's calls for the comparison,
and a spy on a name of one of the program's modules.

An entry is ``entries/<entry>.py``, named by the mix's ``entry`` and
found by ``harness.cells.load_entry``. It exports

  drive(ctx) -> Run    set up and warm up (ending with
                       ``ctx.setup_done()``), measure for ``ctx.seconds``
                       (ending with ``ctx.window_done()``), then, traced,
                       the spans and the profiled stretch
  check(ctx, captures, weights, precision="float32", flops=None,
        notes=None) -> {number: value}
                       the comparison of the captures with the plain
                       reference (``harness/check.py``)
  control(ctx, cfg, net, device) -> captures
                       what the reference ``net`` put in the program's
                       place produces, in the captures' form

Only the entries, the families (``families/``), ``harness/ranks.py``
and this module import the program."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness.weights import load_into


class Sampler:
    """A reservoir of ``k`` calls of the window, drawn from the seed: the
    slot call ``i`` is kept in, or None. The choice does not depend on
    what the call produces, so it is made before the call."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.kept: List[Optional[Dict]] = [None] * k

    def slot(self, i: int) -> Optional[int]:
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def items(self) -> List[Dict]:
        return [x for x in self.kept if x is not None]


class Run:
    """What a driver hands back: calls attempted and failed, the window's
    length and each call's latency, the per-layer readings (spans,
    trace) of a traced run, and the captures for the comparison."""

    def __init__(self):
        self.latencies: List[float] = []
        self.window_s = 0.0
        self.calls = 0
        self.failed = 0
        self.samples_per_call = 1
        self.spans: Dict[str, List[float]] = {}
        self.trace = None
        self.captures: List[Dict] = []


def build_model(program_cfg_json: str, config: Dict, family):
    """The program's configuration and model (on the CPU, weights not
    set) from the configuration file, built by its ``family``
    (``harness.cells.family_of``)."""
    from dodt_tpu_torch.config import PipelineConfig
    cfg = PipelineConfig.from_json(program_cfg_json)
    return cfg, family.program(cfg, config)


def load(model, weights: Dict, device: torch.device):
    """The model on ``device`` holding ``weights``, in eval mode."""
    model = model.to(device)
    load_into(model, weights)
    return model.eval()


def sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


@contextlib.contextmanager
def spy(module, name: str, wrap: Callable[[Callable], Callable]):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)
