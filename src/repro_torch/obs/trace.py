"""Span-based tracing with a Chrome-trace/Perfetto JSON exporter.

A copy of the reference's ``repro/obs/trace.py`` (pure Python).

``Tracer`` records nested spans (``with tracer.span("prefill_chunk",
rid=3):``) against an injectable monotonic clock — real runs use
``time.perf_counter``, tests inject a fake clock for byte-deterministic
output.  Spans are Chrome-trace "complete" events (``ph: "X"`` with
``ts``/``dur`` in microseconds); lanes are ``tid``s named via
``set_thread_name``.  Because spans close through a per-lane context
stack, events on one lane always nest properly.

Spans time host work.  Around an asynchronous CUDA call (an eager kernel
launch, or a CUDA graph's replay) a span measures the launch, not the
device's work, as a span around a jitted call does in the reference; the
tracer adds no synchronisation.

Open the exported file at https://ui.perfetto.dev (or
``chrome://tracing``): lanes render as threads, ``args`` show in the
selection panel.

Two adapters render the simulator onto the same timeline:

* ``round_walk_chrome_trace`` — the mapper's per-round overlap
  recurrence (``start_{r+1} = start_r + c_r + max(0, p_{r+1} - c_r)``,
  see ``repro_torch.sim.mapper.round_timeline``) as compute/program/stall
  lanes;
* ``sim_chrome_trace`` — a ``repro_torch.sim.trace.Trace``'s tile-class
  events laid end-to-end per kind (occupancy view).

Simulator timelines use 1 cycle = 1 µs ticks unless ``freq_hz`` is
given (Perfetto only needs consistent units).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional


@dataclasses.dataclass
class TraceEvent:
    """One Chrome-trace event (complete span, instant, or metadata)."""
    name: str
    ph: str                       # "X" span | "i" instant | "C" counter | "M"
    ts: float                     # microseconds from trace zero
    dur: float = 0.0
    pid: int = 0
    tid: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cat: str = ""

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "ph": self.ph,
                             "ts": self.ts, "pid": self.pid, "tid": self.tid}
        if self.ph == "X":
            d["dur"] = self.dur
        if self.ph == "i":
            d["s"] = "t"          # thread-scoped instant
        if self.args:
            d["args"] = self.args
        if self.cat:
            d["cat"] = self.cat
        return d


def chrome_doc(events: Iterable[TraceEvent],
               thread_names: Optional[Dict[int, str]] = None,
               pid: int = 0) -> Dict[str, Any]:
    """Wrap events into a Chrome-trace JSON object (metadata first, then
    events sorted by (ts, -dur) so parents precede their children)."""
    meta = [TraceEvent("thread_name", "M", 0.0, pid=pid, tid=tid,
                       args={"name": name})
            for tid, name in sorted((thread_names or {}).items())]
    body = sorted(events, key=lambda e: (e.ts, -e.dur, e.tid))
    return {"traceEvents": [e.to_json() for e in meta + body],
            "displayTimeUnit": "ms"}


class Tracer:
    """Collects spans/instants against a monotonic clock.

    ``clock`` returns seconds (monotonic); timestamps are zero-based at
    construction and exported in microseconds.  Single-process,
    single-thread by design — lanes (``tid``) are logical tracks
    (engine, slots, phases), not OS threads.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 pid: int = 0):
        self._clock = clock
        self.pid = pid
        self._t0 = clock()
        self.events: List[TraceEvent] = []
        self._thread_names: Dict[int, str] = {}
        self._stacks: Dict[int, List[str]] = {}

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def set_thread_name(self, tid: int, name: str) -> None:
        self._thread_names[tid] = name

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, cat: str = "", **args: Any):
        """Record a nested span; always closes, even on exceptions."""
        t_start = self.now_us()
        stack = self._stacks.setdefault(tid, [])
        stack.append(name)
        try:
            yield self
        finally:
            stack.pop()
            self.events.append(TraceEvent(name, "X", t_start,
                                          self.now_us() - t_start,
                                          self.pid, tid, dict(args), cat))

    def instant(self, name: str, tid: int = 0, **args: Any) -> None:
        self.events.append(TraceEvent(name, "i", self.now_us(),
                                      pid=self.pid, tid=tid, args=dict(args)))

    def counter(self, name: str, value: float, tid: int = 0) -> None:
        """A counter track (rendered as a little area chart in Perfetto)."""
        self.events.append(TraceEvent(name, "C", self.now_us(),
                                      pid=self.pid, tid=tid,
                                      args={"value": float(value)}))

    def open_spans(self) -> int:
        """Spans entered but not yet exited (0 == well-formed trace)."""
        return sum(len(s) for s in self._stacks.values())

    def depth(self, tid: int = 0) -> int:
        return len(self._stacks.get(tid, ()))

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_doc(self.events, self._thread_names, self.pid)

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")


# ---------------------------------------------------------------------------
# simulator adapters: engine schedules on the same timeline
# ---------------------------------------------------------------------------

def _cycles_to_us(cycles: float, freq_hz: Optional[float]) -> float:
    return cycles / freq_hz * 1e6 if freq_hz else cycles


def round_walk_chrome_trace(slices, *, name: str = "matmul",
                            freq_hz: Optional[float] = None
                            ) -> Dict[str, Any]:
    """Render ``repro_torch.sim.mapper.round_timeline`` slices as a timeline.

    Three lanes: compute (tid 0), RRAM writes (tid 1), and the exposed
    stall (tid 2) — the part of each round's program time the overlap
    recurrence could not hide behind the previous round's compute.
    Serial mode shows every program fully exposed; double-buffered mode
    shows writes riding under compute with only the ``max(0, p - c)``
    tails surfacing on the stall lane.
    """
    events = []
    for s in slices:
        if s.program_cycles > 0:
            events.append(TraceEvent(
                f"{name} r{s.index} program", "X",
                _cycles_to_us(s.program_start, freq_hz),
                _cycles_to_us(s.program_cycles, freq_hz), tid=1,
                args={"round": s.index, "cycles": s.program_cycles},
                cat="program"))
        if s.compute_cycles > 0:
            events.append(TraceEvent(
                f"{name} r{s.index} compute", "X",
                _cycles_to_us(s.compute_start, freq_hz),
                _cycles_to_us(s.compute_cycles, freq_hz), tid=0,
                args={"round": s.index, "cycles": s.compute_cycles},
                cat="compute"))
        if s.exposed_cycles > 0:
            events.append(TraceEvent(
                f"{name} r{s.index} exposed stall", "X",
                _cycles_to_us(s.compute_start - s.exposed_cycles, freq_hz),
                _cycles_to_us(s.exposed_cycles, freq_hz), tid=2,
                args={"round": s.index, "cycles": s.exposed_cycles},
                cat="stall"))
    return chrome_doc(events, {0: "compute", 1: "rram writes",
                               2: "exposed stall"})


def sim_chrome_trace(trace, *, freq_hz: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Render a ``repro_torch.sim.trace.Trace`` (tile-class events) end-to-end.

    One lane per event kind (compute / reprogram / program), events laid
    sequentially with their total occupancy cycles as duration — an
    occupancy view, not a wall-clock one (wall-clock lives in the round
    walk above; see the trace module's cycles caveat).
    """
    lanes = {"compute": 0, "reprogram": 1, "program": 2}
    cursors = {tid: 0.0 for tid in lanes.values()}
    events = []
    for e in trace.events:
        tid = lanes.get(e.kind, len(lanes))
        t0 = cursors.get(tid, 0.0)
        dur = e.cost.cycles
        events.append(TraceEvent(
            f"{e.matmul} {e.kind} {e.k_rows}x{e.n_words}", "X",
            _cycles_to_us(t0, freq_hz), _cycles_to_us(dur, freq_hz),
            tid=tid,
            args={"tiles": e.tiles, "macs": e.cost.macs,
                  "energy_j": e.cost.energy_j}, cat=e.kind))
        cursors[tid] = t0 + dur
    return chrome_doc(events, {0: "compute occupancy",
                               1: "reprogram occupancy",
                               2: "initial programming"})
