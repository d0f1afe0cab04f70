"""Fault-tolerance runtime: supervisor, chaos harness, straggler monitor.

The reference's ``repro.runtime.fault_tolerance`` (pure Python), copied.
At thousand-node scale the interesting failures are (a) whole-job
crashes (power, preemption) -> checkpoint and auto-resume; (b) slow
nodes (thermal, network) -> straggler detection; (c) shrink and grow
events -> elastic re-mesh, which waits for the port's ``dist/``.  This
module holds the control-plane pieces; the data plane (snapshots, the
async writer, restore) lives in ``repro_torch.ckpt``.

Two supervision layers:

  * ``Supervisor`` restarts an in-process training *function* with a
    configurable restart predicate (by default only ``InjectedFailure``,
    the test hook; pass ``should_restart=lambda e: True``, or any
    predicate, so that real faults auto-resume in production);
  * ``ChaosSupervisor`` supervises a real training *subprocess* and can
    kill it (SIGKILL by default) when its telemetry shows a target step:
    the harness of the crash/resume chaos tests, which hold the loss
    curve bitwise to an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal as _signal
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional


class InjectedFailure(RuntimeError):
    """A simulated node failure."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    failed: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.failed:
            self.failed.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """EMA-based step-time anomaly detector.

    On real multi-host deployments each host reports its local step time;
    a host whose time exceeds mean + ``z`` sigma for ``patience`` consecutive
    steps is flagged (the launcher can then demote/replace it).  Here the
    same statistics run over per-step wall times.  Anomalous samples are
    excluded from the EMA update so a straggler stays visible instead of
    dragging the baseline up.
    """
    alpha: float = 0.1
    z: float = 3.0
    patience: int = 3
    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _streak: int = 0
    flagged: List[int] = dataclasses.field(default_factory=list)

    @property
    def mean(self) -> float:
        """Current EMA of non-anomalous step times."""
        return self._mean

    @property
    def std(self) -> float:
        return math.sqrt(max(self._var, 0.0))

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step looks like a straggler event."""
        if self._n > 2:
            sd = math.sqrt(max(self._var, 1e-12))
            is_slow = dt > self._mean + self.z * sd
        else:
            is_slow = False
        # EMA update (skip updating with anomalies so they stay visible)
        if not is_slow:
            d = dt - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        self._n += 1
        self._streak = self._streak + 1 if is_slow else 0
        if self._streak >= self.patience:
            self.flagged.append(step)
            self._streak = 0
            return True
        return False


def _default_should_restart(e: BaseException) -> bool:
    return isinstance(e, InjectedFailure)


@dataclasses.dataclass
class Supervisor:
    """Run a (restartable) training function with bounded auto-resume.

    ``run_fn() -> final_step`` takes no arguments and must itself load the
    latest checkpoint at entry (the trainer's auto-resume path); the
    supervisor only bounds restarts.  ``should_restart`` decides which
    exceptions trigger a restart — the default restarts only on
    ``InjectedFailure`` (the historical test-only behavior); production
    launchers pass a broader predicate (e.g. ``lambda e: True``) so real
    faults auto-resume too.  Anything the predicate rejects propagates.
    """
    max_restarts: int = 5
    backoff_s: float = 0.0
    should_restart: Callable[[BaseException], bool] = _default_should_restart

    def run(self, run_fn: Callable[[], int]) -> Dict[str, object]:
        restarts = 0
        while True:
            try:
                final = run_fn()
                return {"final_step": final, "restarts": restarts}
            except Exception as e:
                if not self.should_restart(e):
                    raise
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                if self.backoff_s:
                    time.sleep(self.backoff_s)


# ---------------------------------------------------------------------------
# Chaos harness: supervise (and kill) a real training subprocess
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KillSpec:
    """When and how to kill one attempt of a supervised subprocess.

    The watcher fires once the child's observable progress reaches
    ``at_step``, then waits ``delay_s`` (lets the kill land mid-next-step
    or mid-checkpoint-write) and sends ``sig`` — SIGKILL by default, the
    crash no handler can soften.  Progress is read from ``metrics_path``
    (the trainer's JSONL telemetry: fires on a logged step) and/or
    ``ckpt_dir`` (fires on a *completed* checkpoint directory — use this
    to guarantee the restarted attempt has something to restore; a fast
    child can log many steps before its async writer retires the first
    checkpoint).  At least one of the two must be set.
    """
    at_step: int
    metrics_path: Optional[str] = None
    ckpt_dir: Optional[str] = None
    delay_s: float = 0.0
    sig: int = int(_signal.SIGKILL)

    def progress(self) -> int:
        """The child's largest observable step right now."""
        best = -1
        if self.metrics_path is not None:
            best = max(best, _tail_max_step(self.metrics_path))
        if self.ckpt_dir is not None:
            from repro_torch.ckpt import checkpoint as _ckpt
            steps = _ckpt.all_steps(self.ckpt_dir)
            if steps:
                best = max(best, steps[-1])
        return best


@dataclasses.dataclass
class KillEvent:
    """What actually happened to one attempt."""
    attempt: int
    at_step: int
    returncode: int


def _tail_max_step(path: str) -> int:
    """Largest ``step`` in a (possibly torn) JSONL telemetry file."""
    if not os.path.exists(path):
        return -1
    best = -1
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:  # torn tail mid-write
                continue
            if isinstance(rec, dict) and "step" in rec:
                best = max(best, int(rec["step"]))
    return best


def final_loss_history(path: str) -> Dict[int, float]:
    """Per-step loss from JSONL telemetry, last record per step winning.

    A crashed-and-resumed run re-logs the steps it recomputed after
    restore; the *final* value per step is the one the run stands behind,
    and is what the chaos tests compare bitwise against an uninterrupted
    reference.
    """
    out: Dict[int, float] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "step" in rec and "loss" in rec:
                out[int(rec["step"])] = float(rec["loss"])
    return out


@dataclasses.dataclass
class ChaosSupervisor:
    """Run a training subprocess, kill it on cue, restart it, bounded.

    Each attempt runs ``argv`` with ``CHAOS_ATTEMPT=<k>`` in its
    environment (a child can e.g. come back on a different mesh carving).
    ``kill_plan(attempt)`` returns the ``KillSpec`` for that attempt, or
    None to let it run to completion.  ``between_attempts(attempt)`` runs
    after a kill and before the restart — the hook the chaos tests use to
    plant a torn ``.tmp`` checkpoint directory.  Restarts and kills emit
    through the optional ``repro_torch.obs`` bundle (``chaos.*`` counters).
    """
    argv: List[str]
    env: Optional[Dict[str, str]] = None
    max_restarts: int = 5
    poll_s: float = 0.05
    timeout_s: float = 900.0
    obs: Optional[object] = None

    def _count(self, name: str, value: float = 1.0) -> None:
        if self.obs is not None and getattr(self.obs, "registry", None):
            self.obs.registry.counter(name, value)

    def run(self, kill_plan: Callable[[int], Optional[KillSpec]],
            between_attempts: Optional[Callable[[int], None]] = None
            ) -> Dict[str, object]:
        """-> {"restarts", "kills": [KillEvent...], "stdout": [str...]}."""
        kills: List[KillEvent] = []
        stdouts: List[str] = []
        attempt = 0
        while True:
            spec = kill_plan(attempt)
            env = dict(self.env or os.environ)
            env["CHAOS_ATTEMPT"] = str(attempt)
            proc = subprocess.Popen(self.argv, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            killed_at = {"step": -1}

            def _watch(spec=spec, proc=proc, killed_at=killed_at):
                while proc.poll() is None:
                    step = spec.progress()
                    if step >= spec.at_step:
                        if spec.delay_s:
                            time.sleep(spec.delay_s)
                        killed_at["step"] = step
                        try:
                            proc.send_signal(spec.sig)
                        except ProcessLookupError:  # finished just now
                            pass
                        return
                    time.sleep(self.poll_s)

            watcher = None
            if spec is not None:
                watcher = threading.Thread(target=_watch, daemon=True)
                watcher.start()
            try:
                out, _ = proc.communicate(timeout=self.timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                raise RuntimeError(
                    f"chaos attempt {attempt} timed out\n{out[-2000:]}")
            if watcher is not None:
                watcher.join(timeout=5.0)
            stdouts.append(out or "")
            if proc.returncode == 0:
                return {"restarts": attempt, "kills": kills,
                        "stdout": stdouts}
            kills.append(KillEvent(attempt=attempt,
                                   at_step=killed_at["step"],
                                   returncode=proc.returncode))
            self._count("chaos.kills")
            attempt += 1
            self._count("chaos.restarts")
            if attempt > self.max_restarts:
                raise RuntimeError(
                    f"exceeded {self.max_restarts} restarts; last output:\n"
                    f"{(out or '')[-2000:]}")
            if between_attempts is not None:
                between_attempts(attempt)
