"""Async checkpoint manager: bounded writer queue, overlap accounting,
compressed optimizer state.

The reference's ``repro.ckpt.manager`` on the port's checkpoint module.
The write path is split in two so that I/O overlaps compute:

  1. ``save(step, tree)`` *snapshots* the tree to host memory on the
     caller's thread (the only part that must see a consistent device
     state), then enqueues the write;
  2. one background writer drains the bounded queue.  Atomicity per
     checkpoint comes from ``checkpoint.write_snapshot``'s rename
     barrier, and because one writer owns the directory, retention passes
     never race concurrent writes.

``save(..., blocking=True)`` and ``wait_until_finished()`` first drain
the queue, so a blocking (final) save never interleaves with a running
async write to the same directory.  Writer exceptions are kept and
raised on the next ``save``/``wait_until_finished`` call rather than
dying silently on the daemon thread.

Overlap accounting: the trainer calls ``step_completed()`` once a train
step; each async write records how many steps completed while it was in
flight (``ckpt.overlapped_steps``).  Durations and queue depth go to the
``repro_torch.obs`` registry, and snapshot/write/restore show as spans
(the writer on a trace lane of its own).

``restore(like, device=...)`` puts the whole leaves on one device; on
a mesh the trainer cuts each rank's pieces from them
(``train_step.shard_state``), so a checkpoint resumes on any mesh or
none (the reference's elastic restore).
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models.params import tree_leaves

#: trace lane for the background writer (0 is the caller's lane)
WRITER_LANE = 9


class CheckpointWriteError(RuntimeError):
    """An async write failed; raised on the next save/wait call."""


def default_compress_filter(path: Tuple[Any, ...], leaf) -> bool:
    """Compress optimizer moments: any leaf under an ``m``/``v`` key below
    an ``opt`` key (the AdamW state layout of ``train.train_step``).
    ``path`` is the leaf's keys from the root."""
    keys = list(path)
    if "opt" not in keys:
        return False
    i = keys.index("opt")
    return len(keys) > i + 1 and keys[i + 1] in ("m", "v")


@dataclasses.dataclass
class SaveRecord:
    """Bookkeeping for one save (tests + telemetry)."""
    step: int
    blocking: bool
    snapshot_s: float = 0.0
    write_s: float = 0.0
    raw_bytes: int = 0
    stored_bytes: int = 0
    overlapped_steps: int = -1   # train steps completed while in flight


@dataclasses.dataclass
class _Job:
    step: int
    snap: ckpt.Snapshot
    codecs: List[Optional[str]]
    record: SaveRecord
    steps_at_enqueue: int


class CheckpointManager:
    """Owns one checkpoint directory: async saves, retention, restore."""

    def __init__(self, directory: str, *, keep: int = 3,
                 max_in_flight: int = 2, compress_opt_state: bool = True,
                 compress_filter: Optional[Callable[..., bool]] = None,
                 write_throttle_s: float = 0.0, obs=None):
        self.directory = directory
        self.keep = keep
        self.compress_filter = (
            compress_filter if compress_filter is not None
            else (default_compress_filter if compress_opt_state
                  else (lambda path, leaf: False)))
        self.write_throttle_s = write_throttle_s
        self.saves: List[SaveRecord] = []
        self._registry = obs.registry if obs is not None else None
        self._tracer = getattr(obs, "tracer", None) if obs is not None else None
        if self._tracer is not None:
            self._tracer.set_thread_name(WRITER_LANE, "ckpt-writer")
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue(
            maxsize=max(1, max_in_flight))
        self._writer: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        self._steps_done = 0
        self._lock = threading.Lock()
        removed = ckpt.clean_torn(directory)
        if removed and self._registry is not None:
            self._registry.counter("ckpt.torn_tmp_cleaned", len(removed))

    # -- obs helpers -------------------------------------------------------

    def _span(self, name: str, tid: int = 0, **args):
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, tid=tid, **args)

    def _observe(self, name: str, value: float, **labels) -> None:
        if self._registry is not None:
            self._registry.observe(name, value, **labels)

    def _count(self, name: str, value: float = 1.0, **labels) -> None:
        if self._registry is not None:
            self._registry.counter(name, value, **labels)

    def _gauge(self, name: str, value: float, **labels) -> None:
        if self._registry is not None:
            self._registry.gauge(name, value, **labels)

    # -- save path ---------------------------------------------------------

    def step_completed(self) -> None:
        """Tell the manager a train step finished (overlap accounting)."""
        with self._lock:
            self._steps_done += 1

    def _codecs_for(self, tree) -> List[Optional[str]]:
        flat = tree_leaves(tree)
        return ["int8_ef" if self.compress_filter(path, leaf) else None
                for path, leaf in flat]

    def _raise_pending(self) -> None:
        if self._errors:
            err = self._errors[0]
            raise CheckpointWriteError(
                f"background checkpoint write failed: {err!r}") from err

    def save(self, step: int, tree, *, blocking: bool = False
             ) -> SaveRecord:
        """Checkpoint ``tree`` as ``step``.

        Async (default): snapshots to host now, writes in the background,
        returns immediately.  Blocking: drains any outstanding async
        writes first (join-before-blocking-save), then writes inline.
        """
        self._raise_pending()
        codecs = self._codecs_for(tree)
        record = SaveRecord(step=step, blocking=blocking)
        t0 = time.perf_counter()
        with self._span("ckpt.snapshot", step=step):
            snap = ckpt.snapshot(tree)
        record.snapshot_s = time.perf_counter() - t0
        record.raw_bytes = snap.nbytes
        self._observe("ckpt.snapshot_s", record.snapshot_s)
        self._count("ckpt.saves")
        if blocking:
            self.wait_until_finished()
            self._write(_Job(step, snap, codecs, record,
                             self._steps_done), tid=0)
            self.saves.append(record)
            return record
        self._ensure_writer()
        job = _Job(step, snap, codecs, record, self._steps_done)
        self._queue.put(job)   # bounded: blocks (backpressure) when full
        self._gauge("ckpt.queue_depth", self._queue.qsize())
        self.saves.append(record)
        return record

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(target=self._writer_loop,
                                            name="ckpt-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._write(job, tid=WRITER_LANE)
            except BaseException as e:  # surfaced on next save/wait
                self._errors.append(e)
                self._count("ckpt.write_errors")
            finally:
                self._gauge("ckpt.queue_depth", self._queue.qsize())
                self._queue.task_done()

    def _write(self, job: _Job, *, tid: int) -> None:
        t0 = time.perf_counter()
        with self._span("ckpt.write", tid=tid, step=job.step):
            stats = ckpt.write_snapshot(
                self.directory, job.step, job.snap, keep=self.keep,
                codecs=job.codecs, throttle_s=self.write_throttle_s)
        job.record.write_s = time.perf_counter() - t0
        job.record.stored_bytes = stats["stored_bytes"]
        with self._lock:
            job.record.overlapped_steps = (self._steps_done
                                           - job.steps_at_enqueue)
        self._observe("ckpt.write_s", job.record.write_s)
        self._observe("ckpt.overlapped_steps",
                      float(job.record.overlapped_steps))
        self._count("ckpt.bytes_written", stats["stored_bytes"])

    def wait_until_finished(self) -> None:
        """Block until every enqueued write is durable; re-raise writer
        failures.  Call before any blocking save, retention decision, or
        handing the directory to another process (restart)."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain outstanding writes and stop the writer thread."""
        self._queue.join()
        if self._writer is not None and self._writer.is_alive():
            self._queue.put(None)
            self._writer.join()
        self._writer = None
        self._raise_pending()

    # -- restore path ------------------------------------------------------

    def all_steps(self) -> List[int]:
        return ckpt.all_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return ckpt.latest_step(self.directory)

    def restore(self, like, *, step: Optional[int] = None, device="cpu"
                ) -> Tuple[Any, int]:
        """Restore ``(tree, step)`` (the newest step unless given) as
        tensors on ``device``.  Checks the saved structure against
        ``like`` and every leaf's crc32."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        t0 = time.perf_counter()
        with self._span("ckpt.restore", step=step):
            tree = ckpt.restore(self.directory, step, like, device=device)
        self._observe("ckpt.restore_s", time.perf_counter() - t0)
        self._count("ckpt.restores")
        return tree, step
