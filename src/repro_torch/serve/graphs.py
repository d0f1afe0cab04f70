"""CUDA graphs of the paged engine's two entry points.

The reference compiles ``model.decode_step`` and ``model.prefill_chunk``
with ``jax.jit`` (``repro/serve/paged_engine.py``): one XLA program per
entry point and shape, the cache's gather and commit outside it.  On the
card the counterpart is one CUDA graph per entry point and shape key,
replayed over static input buffers:

* ``inputs(key, make)`` returns the key's static inputs (made by
  ``make()`` on first use); the engine writes this step's values into
  them (tokens, positions, and the gathered cache view, every cell of it);
* ``entry(key)`` runs the entry point on them.  On CUDA the first call of
  a key runs it once eagerly (a warm-up that makes every lazily built
  constant and library state), captures it into a graph from the engine's
  one memory pool, then replays it; later calls replay.  The outputs are
  the static tensors the capture returned (the logits, and the view the
  model updated in place), valid until the next call of any graph of the
  pool, so the engine reads them first.  The warm-up writes into the
  static inputs (the view's cache cells, and a recurrent state such as
  zamba2's, which a step reads before it writes), so their values are
  kept before the warm-up and put back before the first replay: the
  replay starts from what the caller wrote.
* Without capture (on the CPU, or ``capture=False``, the counterpart of
  ``jax.disable_jit()``) ``entry(key)`` calls the function on the same
  static buffers, so the buffer handling is the same on both devices.

A capture that fails raises; nothing falls back to eager.  The graphs
keep pointers into the parameters and the static buffers, so neither may
be replaced after capture.  The warm-up and every replay run on the
caller's stream, one after another (``torch.cuda.graph`` synchronises
before it captures on its own side stream, where nothing runs), which
keeps absmax's device-global ticket and partials (``csrc/absmax.cu``)
safe.  Python's cyclic garbage collector is off during a capture: a
dead reference cycle that holds another graph (an engine dropped
earlier) would otherwise be collected whenever the capture's allocations
cross its threshold, and destroying a graph while a stream captures
invalidates the capture (``cudaErrorStreamCaptureInvalidated``).

``build.LAUNCHES`` counts a kernel where its wrapper launches it.  A
replay launches the kernels that its capture recorded without calling
the wrappers, so each replay adds the counts its capture recorded, and
the capture itself, which runs nothing, adds none.

``_cache_size()`` is ``count`` under the name that
``obs.RetraceWatchdog`` reads, so the watchdog's ``jit_compiled_shapes``
series counts captured graphs on the card.  The warm-up and the capture
record nothing in ``kernels.metrics`` (as the reference's trace under
jit records nothing), and a replay calls no op.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import metrics
from repro_torch.kernels.build import LAUNCHES


@dataclasses.dataclass
class _Shape:
    inputs: tuple
    graph: Optional[Any] = None          # torch.cuda.CUDAGraph once captured
    outputs: Any = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


class GraphedEntry:
    """One entry point ``fn(*inputs)``, specialised per shape key."""

    def __init__(self, fn: Callable, *, capture: bool, pool=None):
        self.fn, self.capture, self._pool = fn, capture, pool
        self._shapes: Dict[Hashable, _Shape] = {}
        self.capture_s = 0.0             # warm-ups and captures, host clock

    @property
    def count(self) -> int:
        """Shapes specialised: graphs captured when capturing, else sets of
        static buffers."""
        if self.capture:
            return sum(s.graph is not None for s in self._shapes.values())
        return len(self._shapes)

    def _cache_size(self) -> int:
        """``count``, under the name ``obs.RetraceWatchdog`` reads (a
        jitted function's, in the reference)."""
        return self.count

    def inputs(self, key: Hashable, make: Callable[[], tuple]) -> tuple:
        shape = self._shapes.get(key)
        if shape is None:
            shape = self._shapes[key] = _Shape(tuple(make()))
        return shape.inputs

    def __call__(self, key: Hashable):
        shape = self._shapes[key]
        if not self.capture:
            return self.fn(*shape.inputs)
        if shape.graph is None:
            self._capture(shape)
        shape.graph.replay()
        LAUNCHES.update(shape.launches)
        return shape.outputs

    def _capture(self, shape: _Shape) -> None:
        t0 = time.perf_counter()
        static = list(_tensors(shape.inputs))
        kept = [t.clone() for t in static]
        with metrics.paused():           # the counterpart of a jit trace
            self.fn(*shape.inputs)       # warm-up, eager
            before = collections.Counter(LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    shape.outputs = self.fn(*shape.inputs)
            finally:
                if collecting:
                    gc.enable()
        shape.launches = dict(collections.Counter(LAUNCHES) - before)
        LAUNCHES.clear()                 # the capture itself ran nothing
        LAUNCHES.update(before)
        for t, v in zip(static, kept):   # undo the warm-up's writes
            t.copy_(v)
        shape.graph = graph
        self.capture_s += time.perf_counter() - t0


def _tensors(tree):
    """The tensors of nested tuples, lists and dicts of static inputs."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
