"""repro_torch.obs — metrics, tracing and the shape watchdog.

The port's copy of the reference's ``repro.obs`` (pure Python, so it is
copied, not imported):

  registry.py  process-local counters/gauges/histograms with labeled
               series (snapshot / to_jsonl), and the append-only JSONL
               step logger
  trace.py     span-based tracing (injectable monotonic clock, nesting,
               lanes) with a Chrome-trace/Perfetto exporter; the
               simulator adapters come with the port of ``sim/``
  watchdog.py  per-callsite bounds on specialised shapes, asserted live;
               over the port's ``GraphedEntry`` it counts captured CUDA
               graphs (series ``jit_compiled_shapes``, the reference's
               name)

``Observability`` is the bundle the instrumented layers accept: the paged
serving engine takes an optional ``obs`` and adds no work without one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.registry import (JsonlLogger, MetricsRegistry,
                                      percentile, read_metrics,
                                      step_time_summary)
from repro_torch.obs.trace import TraceEvent, Tracer, chrome_doc
from repro_torch.obs.watchdog import (RetraceError, RetraceWatchdog,
                                      call_signature)


@dataclasses.dataclass
class Observability:
    """What an instrumented layer needs, in one handle.

    Any field may be None: the registry is the cheap always-on half,
    the tracer opts into timeline capture, the watchdog opts into live
    shape-bound assertion.
    """
    registry: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)
    tracer: Optional[Tracer] = None
    watchdog: Optional[RetraceWatchdog] = None

    @classmethod
    def make(cls, *, trace: bool = False, watchdog_limit: Optional[int] = None,
             clock=None) -> "Observability":
        """A registry, optionally a tracer (with ``clock`` injected for
        deterministic tests) and a raise-mode watchdog pinned at
        ``watchdog_limit`` shapes per callsite."""
        registry = MetricsRegistry()
        tracer = (Tracer(clock) if clock is not None else Tracer()) \
            if trace else None
        wd = (RetraceWatchdog(registry, default_limit=watchdog_limit)
              if watchdog_limit is not None else None)
        return cls(registry=registry, tracer=tracer, watchdog=wd)


__all__ = [
    "JsonlLogger", "MetricsRegistry", "percentile", "read_metrics",
    "step_time_summary", "TraceEvent", "Tracer", "chrome_doc",
    "RetraceError", "RetraceWatchdog", "call_signature", "Observability",
]
