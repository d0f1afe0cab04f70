"""Compile/capture watchdog: live-asserted bounds on specialised shapes.

A copy of the reference's ``repro/obs/watchdog.py``.  A new shape is
silent: the program stays correct, but each one costs a compile in the
reference and a warm-up and capture in the port.  The paged engine's
shape discipline (power-of-two prefill chunks, bucketed view lengths,
constant decode batch) pins that count at O(log max_len); this module
asserts it *while the engine runs*.

``RetraceWatchdog.watch(fn, name=..., limit=N)`` wraps a callable.  After
every call it counts the distinct specialisations — preferring the
callable's own ``_cache_size()`` and falling back to counting distinct
argument signatures (pytree structure + leaf shape/dtype) — publishes
the count as a gauge (``jit_compiled_shapes{callsite=name}``, the
reference's name), and raises ``RetraceError`` (or just counts,
``mode="record"``) the moment the bound is exceeded.  The port's
callables are ``serve.graphs.GraphedEntry`` objects, whose
``_cache_size()`` is their ``count``: on the card the series counts
captured CUDA graphs, off it the sets of static buffers.  The wrapper
forwards ``_cache_size``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from torch.utils import _pytree as pytree


class RetraceError(RuntimeError):
    """A watched callsite compiled more distinct shapes than its bound."""


def call_signature(args: Tuple, kwargs: Dict) -> Tuple:
    """Hashable retrace identity of one call: pytree structure plus each
    leaf's (shape, dtype) — or type for non-array leaves."""
    leaves, treedef = pytree.tree_flatten((args, kwargs))
    sig = []
    for leaf in leaves:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            sig.append(("arr", tuple(leaf.shape), str(leaf.dtype)))
        else:
            sig.append(("py", type(leaf).__name__))
    return (str(treedef), tuple(sig))


@dataclasses.dataclass
class _Site:
    fn: Callable
    limit: int
    signatures: set = dataclasses.field(default_factory=set)
    calls: int = 0
    violations: int = 0

    def compiled(self) -> int:
        size = getattr(self.fn, "_cache_size", None)
        if callable(size):
            return size()
        return len(self.signatures)


class RetraceWatchdog:
    """Tracks compile counts per watched callsite against a bound.

    ``mode="raise"`` (default) raises ``RetraceError`` on the first
    violating call; ``mode="record"`` only counts violations (read them
    back via ``report()``/``assert_ok()``).  ``default_limit`` overrides
    the per-``watch`` limit when set — how a smoke harness pins one
    global bound (e.g. 16) over every entry point it wraps.
    """

    def __init__(self, registry=None, mode: str = "raise",
                 default_limit: Optional[int] = None):
        assert mode in ("raise", "record"), mode
        self.registry = registry
        self.mode = mode
        self.default_limit = default_limit
        self._sites: Dict[str, _Site] = {}

    def watch(self, fn: Callable, name: Optional[str] = None,
              limit: int = 16) -> Callable:
        """Wrap ``fn``; every call updates and checks the compile count."""
        name = name or getattr(fn, "__name__", "fn")
        site = _Site(fn, self.default_limit
                     if self.default_limit is not None else limit)
        self._sites[name] = site

        def wrapped(*args, **kwargs):
            site.signatures.add(call_signature(args, kwargs))
            out = fn(*args, **kwargs)
            site.calls += 1
            self._check(name, site)
            return out

        wrapped.__wrapped__ = fn
        cache_size = getattr(fn, "_cache_size", None)
        if callable(cache_size):
            wrapped._cache_size = cache_size
        return wrapped

    def _check(self, name: str, site: _Site) -> None:
        n = site.compiled()
        if self.registry is not None:
            self.registry.gauge("jit_compiled_shapes", n, callsite=name)
        if n > site.limit:
            site.violations += 1
            if self.registry is not None:
                self.registry.counter("jit_retrace_violations", callsite=name)
            if self.mode == "raise":
                raise RetraceError(
                    f"{name}: {n} compiled shapes exceeds the bound of "
                    f"{site.limit} — a shape leaked past the bucketing")

    def compiled(self, name: str) -> int:
        return self._sites[name].compiled()

    def report(self) -> Dict[str, Dict[str, int]]:
        return {name: {"compiled": s.compiled(), "limit": s.limit,
                       "calls": s.calls, "violations": s.violations}
                for name, s in sorted(self._sites.items())}

    def assert_ok(self) -> None:
        """Raise if any watched site is (or ever was) over its bound."""
        for name, s in sorted(self._sites.items()):
            if s.violations or s.compiled() > s.limit:
                raise RetraceError(
                    f"{name}: {s.compiled()} compiled shapes "
                    f"(bound {s.limit}, {s.violations} violation(s))")
