"""CUDA graphs of a model stage whose shapes are static
(``torch.cuda.graphs``).

The host issues a stage's few hundred small launches one by one, and the
card waits for it. ``GraphCache`` captures the stage once per static
signature and then replays it as one graph launch:

* the stage's inputs are copied into buffers the cache owns before each
  replay; a tuple of tensors is stacked on axis 1 straight into its
  buffer, so stacking and copying are one pass;
* the first call of a signature runs the stage eagerly on a side stream
  (that call's result, and the warm-up ``torch.cuda.graphs`` asks for:
  lazy set-up and caches outside the graph), then captures it;
* a replay returns clones of the graph's outputs, so a result a caller
  holds is never overwritten by the next replay;
* each ``_cuda.CudaKernel``'s launches in the capture are undone at
  capture (nothing ran) and added on every replay, so the launch counts
  still show which kernels the stage ran.

Nothing in the stage may wait for the card or copy from the host: the
capture raises where it does.

The rule for every stage a model hands to ``GraphCache.call``:
1. on the CPU (the first input tensor) or with grad on, it runs eagerly,
   uncounted;
2. else with draws, or with a tensor-parallel ``Dense`` (``tp`` set,
   whose collectives a graph does not hold) among the stage's modules,
   it runs eagerly and counts one in ``eager``;
3. else it replays, keyed on the caller's key, the inputs' signature and
   the data pointers of the stage's modules' parameters.
Counters: ``captures``, ``replays`` and ``eager`` (rule 2's calls and
the capturing ones).
"""
from __future__ import annotations

from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple, Union)

import torch

from dodt_tpu_torch.ops import _cuda
from dodt_tpu_torch.utils.metrics import span

# an input: a tensor, None (absent), or tensors stacked on axis 1
Source = Union[torch.Tensor, None, Tuple[torch.Tensor, ...]]


def _signature(src: Source) -> Hashable:
    if src is None:
        return None
    if isinstance(src, tuple):
        return tuple(_signature(t) for t in src)
    return (tuple(src.shape), src.dtype, src.device)


def _stacked(src: Source) -> Optional[torch.Tensor]:
    """``src`` as one tensor (or None): a tuple stacked on axis 1."""
    return torch.stack(src, 1) if isinstance(src, tuple) else src


def _materialize(src: Source) -> Optional[torch.Tensor]:
    """A buffer of the cache's own, holding ``src``'s values."""
    return src.clone() if isinstance(src, torch.Tensor) else _stacked(src)


def _fill(buf: Optional[torch.Tensor], src: Source) -> None:
    if src is None:
        return
    if isinstance(src, tuple):
        torch.stack(src, 1, out=buf)
    else:
        buf.copy_(src)


def _clone(out: Dict[str, Optional[torch.Tensor]]
           ) -> Dict[str, Optional[torch.Tensor]]:
    return {k: None if v is None else v.clone() for k, v in out.items()}


class _Entry:
    def __init__(self, graph, params, inputs, outputs, launches):
        self.graph = graph
        self.params = params
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


class GraphCache:
    """Replays ``fn`` as a CUDA graph, one per signature: the key the
    caller gives and the shapes, dtypes and devices of the inputs. An
    entry also records ``params`` (the data pointers of the weights the
    stage reads): where they change, the entry is captured again and
    the old graph dropped, so a replaced weight tensor is never read
    stale (weights updated in place are read by every replay)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self._entries: Dict[Hashable, _Entry] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def clear(self) -> None:
        """Drop every graph and its buffers."""
        self._entries.clear()

    # graphs and streams are the process's own: a copy (deepcopy or
    # pickle) starts empty
    def __reduce__(self):
        return GraphCache, ()

    def call(self, fn: Callable[..., Dict[str, Optional[torch.Tensor]]],
             sources: Sequence[Source], key: Hashable,
             modules: Sequence[torch.nn.Module], rand: Optional[Callable]
             ) -> Dict[str, Optional[torch.Tensor]]:
        """``fn(*inputs)`` by the module docstring's rule: eagerly on
        ``sources`` (tuples stacked on axis 1) or as ``run``'s replay;
        ``rand`` is the stage's draws (or None)."""
        first = next(s[0] if isinstance(s, tuple) else s for s in sources
                     if s is not None)
        if first.device.type == "cuda" and not torch.is_grad_enabled():
            subs = [sub for m in modules for sub in m.modules()]
            if rand is None and all(getattr(sub, "tp", None) is None
                                    for sub in subs):
                return self.run(fn, sources, key, tuple(
                    p.data_ptr() for sub in subs
                    for p in sub.parameters(recurse=False)))
            self.eager += 1
        return fn(*(_stacked(s) for s in sources))

    def run(self, fn: Callable[..., Dict[str, Optional[torch.Tensor]]],
            sources: Sequence[Source], key: Hashable,
            params: Tuple[int, ...]) -> Dict[str, Optional[torch.Tensor]]:
        """``fn(*inputs)``, its dict of CUDA tensors (or None) cloned,
        with ``inputs`` made from ``sources`` (tensors, None, or tuples
        of tensors stacked on axis 1)."""
        sig = (key, tuple(_signature(s) for s in sources))
        entry = self._entries.get(sig)
        if entry is None or entry.params != params:
            return self._capture(sig, fn, sources, params)
        for buf, src in zip(entry.inputs, sources):
            _fill(buf, src)
        with span("dodt/graph_replay"):
            entry.graph.replay()
        for kernel, n in entry.launches:
            kernel.launches += n
        self.replays += 1
        return _clone(entry.outputs)

    def _capture(self, sig, fn, sources, params):
        inputs: List[Optional[torch.Tensor]] = [_materialize(s)
                                                for s in sources]
        device = next(t for t in inputs if t is not None).device
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        side, cur = self._streams[device], torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = fn(*inputs)
        cur.wait_stream(side)
        result = _clone(warm)
        for v in warm.values():
            if v is not None:
                v.record_stream(cur)
        del warm
        graph = torch.cuda.CUDAGraph()
        before = [k.launches for k in _cuda.KERNELS]
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            outputs = fn(*inputs)
        launches = [(k, k.launches - n) for k, n in zip(_cuda.KERNELS, before)
                    if k.launches != n]
        for kernel, n in launches:
            kernel.launches -= n
        # an entry of old weights goes now: the capture synced the card
        self._entries[sig] = _Entry(graph, params, inputs, outputs, launches)
        self.captures += 1
        self.eager += 1
        return result
