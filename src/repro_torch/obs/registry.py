"""Process-local metrics: labeled counters/gauges/histograms + the
append-only JSONL step logger.

A copy of the reference's ``repro/obs/registry.py`` (pure Python), kept
in the port so that it imports nothing of the reference:

* ``MetricsRegistry`` — in-process aggregation.  A series is
  ``(name, labels)``; counters only go up, gauges hold the last value,
  histograms keep raw observations.  ``snapshot()`` is deterministic
  (sorted series, JSON-safe) and ``to_jsonl`` appends one line per
  series.
* ``JsonlLogger`` — the append-only per-step JSONL stream.  Line-buffered
  writes keep it crash-safe: a torn final line is skipped on read, and
  ``close()`` guarantees every ``log()`` call made before it is a
  complete line on disk.

Value fidelity: ``bool`` stays ``bool``, ``int`` and ``float`` pass
through, other numerics (numpy or torch scalars) coerce to ``float``, and
everything else stringifies.  Each record carries exactly one wall-clock
timestamp ``t``; durations inside records should come from
``time.perf_counter()`` deltas, never wall-clock differences.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def percentile(sorted_values: List[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), so
    pure-python summaries agree with ``np.percentile`` exactly."""
    n = len(sorted_values)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_values[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac)


@dataclasses.dataclass
class _Series:
    kind: str                                # "counter" | "gauge" | "histogram"
    labels: Dict[str, str]
    value: float = 0.0                       # counter total / gauge last value
    observations: List[float] = dataclasses.field(default_factory=list)


class MetricsRegistry:
    """Process-local registry of labeled metric series."""

    def __init__(self):
        self._series: Dict[Tuple[str, LabelKey], _Series] = {}

    def _get(self, name: str, kind: str, labels: Mapping[str, Any]) -> _Series:
        key = (name, _label_key(labels))
        s = self._series.get(key)
        if s is None:
            s = _Series(kind, {k: str(v) for k, v in labels.items()})
            self._series[key] = s
        elif s.kind != kind:
            raise ValueError(f"metric {name!r}{dict(labels)!r} already "
                             f"registered as {s.kind}, not {kind}")
        return s

    # -- write side -----------------------------------------------------

    def counter(self, name: str, value: float = 1.0, **labels: Any) -> None:
        """Increment a monotone counter (negative increments are bugs)."""
        if value < 0:
            raise ValueError(f"counter {name!r}: negative increment {value}")
        self._get(name, "counter", labels).value += value

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set a point-in-time value (last write wins)."""
        self._get(name, "gauge", labels).value = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        """Record one histogram observation."""
        self._get(name, "histogram", labels).observations.append(float(value))

    # -- read side ------------------------------------------------------

    def value(self, name: str, **labels: Any) -> float:
        """Current value of a counter/gauge series (0.0 if never written)."""
        s = self._series.get((name, _label_key(labels)))
        if s is None:
            return 0.0
        if s.kind == "histogram":
            raise ValueError(f"{name!r} is a histogram; use snapshot()")
        return s.value

    def snapshot(self) -> List[Dict[str, Any]]:
        """Deterministic JSON-safe dump: one record per series, sorted by
        (name, labels); histograms reduce to count/sum/min/max/p50/p99."""
        out = []
        for (name, _), s in sorted(self._series.items()):
            rec: Dict[str, Any] = {"name": name, "kind": s.kind,
                                   "labels": dict(s.labels)}
            if s.kind == "histogram":
                obs = sorted(s.observations)
                rec.update(count=len(obs), sum=float(sum(obs)))
                if obs:
                    rec.update(min=obs[0], max=obs[-1],
                               p50=percentile(obs, 50),
                               p99=percentile(obs, 99))
            else:
                rec["value"] = s.value
            out.append(rec)
        return out

    def to_jsonl(self, path: str, *, extra: Optional[Dict[str, Any]] = None,
                 wall_time: Optional[float] = None) -> int:
        """Append the snapshot to ``path``, one series per line, each
        stamped with one wall timestamp ``t``.  Returns the line count."""
        recs = self.snapshot()
        t = time.time() if wall_time is None else wall_time
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            for rec in recs:
                rec = {"t": t, **rec, **(extra or {})}
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(recs)


def _json_value(v: Any) -> Any:
    if isinstance(v, bool):                  # before int: bool is an int
        return v
    if isinstance(v, (int, float)):
        return v
    try:
        return float(v)                      # numpy/torch scalars
    except (TypeError, ValueError):
        return str(v)


class JsonlLogger:
    """Append-only JSONL metrics stream (one object per line).

    Crash-safety contract: writes are line-buffered, so at most the final
    line of a crashed process is torn (``read_metrics`` skips it);
    ``flush()``/``close()`` guarantee everything logged so far is
    complete on disk.
    """

    def __init__(self, path: Optional[str], host_id: int = 0):
        self.path = path
        self.host_id = host_id
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, step: int, **metrics: Any) -> None:
        if self._fh is None:
            return
        rec = {"t": time.time(), "host": self.host_id, "step": step}
        for k, v in metrics.items():
            rec[k] = _json_value(v)
        self._fh.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.flush()
            self._fh.close()
            self._fh = None


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL metrics file, skipping a torn tail line."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line after a crash
    return out


def step_time_summary(path: str) -> Dict[str, float]:
    recs = [r for r in read_metrics(path) if "dt" in r]
    if not recs:
        return {}
    dts = sorted(r["dt"] for r in recs)
    n = len(dts)
    return {"n": n, "p50": dts[n // 2], "p95": dts[int(n * 0.95)],
            "max": dts[-1], "mean": sum(dts) / n}
