"""Kernel-library counters on an observability registry.

The fused ops (``ops.oisma_matmul``, ``ops.oisma_mlp``) record into a
module-level ``MetricsRegistry``, the ``kernels.*`` family of the
reference's ``repro/kernels/metrics.py``: calls per kernel, elements
padded to the tile grid, and the analytic bytes saved against the
unfused pipeline (``kernels.traffic``).

Recording happens at eager entry only.  The reference skips it under jit
tracing; the port skips it while a CUDA graph is being captured and
during a ``GraphedEntry``'s warm-up (inside ``paused()``: together the
counterpart of the trace), and a replay calls no op, so it records
nothing, as a jitted call records nothing in the reference.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.registry import MetricsRegistry

_registry = MetricsRegistry()
_paused = 0


def recording() -> bool:
    """False inside ``paused()``."""
    return _paused == 0


@contextlib.contextmanager
def paused():
    """Record nothing inside (a CUDA graph's warm-up and capture)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the sink (e.g. a harness installing a fresh one); returns the
    previous one."""
    global _registry
    prev, _registry = _registry, registry
    return prev


def record_call(kernel: str, *, padded_elements: int = 0,
                bytes_saved: int | None = None) -> None:
    _registry.counter("kernels.calls", kernel=kernel)
    if padded_elements:
        _registry.counter("kernels.padded_elements", padded_elements,
                          kernel=kernel)
    if bytes_saved is not None:
        _registry.gauge("kernels.bytes_saved", bytes_saved, kernel=kernel)
