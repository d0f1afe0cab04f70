"""Meshes of ranks over ``torch.distributed``, and a launcher of ranks.

The reference's ``repro.launch.mesh`` builds jax meshes over devices.
Here a mesh is a named-axis grid of *processes*: ``Mesh({"stage": 2,
"data": 1, "model": 2})`` lays the ranks of the process group out
row-major over ("stage", "data", "model"), as ``jax.make_mesh`` lays out
devices, and makes one process group per set of axes (the ranks that
differ only along those axes).  Its collectives (``all_reduce``,
``all_gather``, ``send``/``recv`` to a neighbour along an axis) name
axes, not groups.

The backend follows from the layout and is never swapped at run time:
``nccl`` when every rank has a card of its own, ``gloo`` when ranks share
one card or run on the CPU.  Gloo has no CUDA send/recv and only some
CUDA collectives, so under gloo every op on a CUDA tensor goes through a
copy in pinned host memory, explicitly: the compute stays on the card.  Each op's
transport ("nccl", "gloo", "gloo via host") and host seconds are kept in
``Mesh.stats``; a "gloo via host" op first waits for the rank's queued
kernels (its copy would wait for them anyway), so its seconds are the
staging and the transport alone, not the compute before it.

A mesh computes on the card unless it is built with ``device="cpu"``:
without CUDA, a mesh built with no device raises.

``launch_ranks`` starts ``n`` processes (``spawn``), initialises the
process group in each (loopback only: ``127.0.0.1`` and
``GLOO_SOCKET_IFNAME=lo``; a timeout of minutes, so that a hung rank
fails the run), runs a function in every rank and returns their results.
A rank that raises, dies or outlives the deadline fails the whole call.

Nothing here touches a device or a process group at import.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import math
import multiprocessing
import os
import queue as _queue
import socket
import time
import traceback
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: process-group timeout: a rank that hangs fails the run in minutes
TIMEOUT = datetime.timedelta(minutes=5)
#: the tag of ``Mesh.gather``'s sends (the pipeline's are microbatches')
GATHER_TAG = 1 << 20
#: the tag of ``Mesh.shift``'s sends (the ring's hops)
SHIFT_TAG = (1 << 20) + 1


# ---------------------------------------------------------------------------
# axis shapes (plain arithmetic: the reference's meshes without devices)
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False,
                         pipeline_stages: int = 1,
                         seq_shards: int = 1) -> Dict[str, int]:
    """The reference's production mesh shape as {axis: size}: 16 x 16 =
    256 chips a pod, 2 x 16 x 16 across two pods; ``pipeline_stages`` (or
    ``seq_shards``) > 1 carves a "stage" (or "seq") axis out of the data
    axis, (S, 16 // S, 16).  The two carvings exclude each other."""
    s, q = pipeline_stages, seq_shards
    if s > 1 and q > 1:
        raise ValueError("stage- and seq-carvings of the data axis are "
                         f"mutually exclusive (got stages={s}, seq={q})")
    pod = {"pod": 2} if multi_pod else {}
    if s > 1 or q > 1:
        name, size = ("stage", s) if s > 1 else ("seq", q)
        if 16 % size:
            raise ValueError(f"{name}={size} must divide the 16-way data "
                             "axis")
        return {**pod, name: size, "data": 16 // size, "model": 16}
    return {**pod, "data": 16, "model": 16}


def host_mesh_shape(n: int, model: int = 1, stages: int = 1,
                    seq: int = 1) -> Dict[str, int]:
    """``make_host_mesh``'s shape for ``n`` ranks: (n // model, model) over
    ("data", "model"), or (stages, n // (stages * model), model) over
    ("stage", "data", "model"), or the same with "seq"."""
    if stages > 1 and seq > 1:
        raise ValueError("stage- and seq-bearing host meshes are mutually "
                         f"exclusive (got stages={stages}, seq={seq})")
    first = ("stage", stages) if stages > 1 else (
        ("seq", seq) if seq > 1 else None)
    lead = first[1] if first else 1
    if n % (lead * model):
        raise ValueError(f"{n} ranks do not split into {lead} x {model}")
    data = n // (lead * model)
    if first:
        return {first[0]: first[1], "data": data, "model": model}
    return {"data": data, "model": model}


def make_host_mesh(model: int = 1, stages: int = 1, seq: int = 1,
                   device="cuda") -> "Mesh":
    """A mesh over every rank of the initialised process group, shaped as
    the reference's ``make_host_mesh`` shapes the host's devices."""
    shape = host_mesh_shape(dist.get_world_size(), model, stages, seq)
    return Mesh(shape, device=device)


def mesh_axis_size(mesh, name: str) -> int:
    """Size of axis ``name`` on ``mesh`` (1 if absent)."""
    return dict(mesh.shape).get(name, 1)


def pick_backend(device, ranks: int) -> str:
    """``nccl`` when each of ``ranks`` ranks has a card of its own,
    ``gloo`` when they share one card or any runs on the CPU
    (``device``: one for every rank, or a list of them)."""
    devices = [device] * ranks if isinstance(device, str) else list(device)
    if any(torch.device(d).type == "cpu" for d in devices):
        return "gloo"
    return "nccl" if ranks <= torch.cuda.device_count() and ranks > 1 \
        else "gloo"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpStat:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0


class Mesh:
    """A row-major named-axis grid over ranks of the process group.

    Built by every rank of the process group at once (it makes process
    groups, a collective act), over all of them or over ``ranks`` (global
    ranks in the grid's row-major order; the others build it too and are
    not ``member``s).  ``shape`` is {axis: size}; ``coords`` a member's
    index on each axis and ``position`` its row-major index; ``device``
    where this rank computes (the card, its current one, unless "cpu" is
    asked for; ``resolve_device``)."""

    def __init__(self, shape: Mapping[str, int], device="cuda",
                 ranks: Optional[Sequence[int]] = None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised process group "
                               "(launch_ranks or init_process_group)")
        self.shape: Dict[str, int] = {k: int(v) for k, v in shape.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        sizes = tuple(self.shape.values())
        self.ranks: Tuple[int, ...] = tuple(
            range(dist.get_world_size()) if ranks is None else ranks)
        if math.prod(sizes) != len(self.ranks):
            raise ValueError(f"mesh {self.shape} needs {math.prod(sizes)} "
                             f"ranks, it is given {len(self.ranks)}")
        self.rank = dist.get_rank()
        self.member = self.rank in self.ranks
        self.backend = dist.get_backend()
        self.device = dev
        self.position = self.ranks.index(self.rank) if self.member else None
        self.coords: Dict[str, int] = {}
        idx = self.position or 0
        for a, s in reversed(list(zip(self.axis_names, sizes))):
            self.coords[a] = idx % s
            idx //= s
        self.coords = {a: self.coords[a] for a in self.axis_names}
        self.stats: Dict[Tuple[str, str], OpStat] = collections.defaultdict(
            OpStat)
        self._pinned: Dict[Tuple[Any, int], torch.Tensor] = {}
        # one group per set of axes of size > 1, made by every rank in
        # the same order (new_group is collective)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        live = [a for a in self.axis_names if self.shape[a] > 1]
        for r in range(1, len(live) + 1):
            for axes in itertools.combinations(live, r):
                mine = None
                for group in self._rank_sets(axes):
                    g = dist.new_group(group)
                    if self.rank in group:
                        mine = g
                self._groups[axes] = mine

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at "
                f"{self.coords if self.member else 'none'}, {self.backend}, "
                f"{self.device})")

    # -- layout ------------------------------------------------------------

    def rank_at(self, coords: Mapping[str, int]) -> int:
        """The global rank at ``coords``."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords[a])
        return self.ranks[r]

    def _rank_sets(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group of ranks that differ only along ``axes``."""
        others = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = []
            for var in itertools.product(*(range(self.shape[a])
                                           for a in axes)):
                ranks.append(self.rank_at({**base, **dict(zip(axes, var))}))
            out.append(sorted(ranks))
        return out

    def _live(self, axes) -> Tuple[str, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def size(self, axes) -> int:
        """Ranks along ``axes`` (an axis name or a tuple of them; absent
        axes count 1)."""
        return math.prod(self.shape[a] for a in self._live(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        i = 0
        for a in self._live(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank along ``axes``, or None when
        the axes hold one rank."""
        live = self._live(axes)
        return self._groups[live] if live else None

    def neighbour(self, axis: str, offset: int) -> Optional[int]:
        """The global rank ``offset`` steps along ``axis``, or None past
        the edge."""
        c = self.coords[axis] + offset
        if not 0 <= c < self.shape[axis]:
            return None
        return self.rank_at({**self.coords, axis: c})

    def _ring_rank(self, axes, offset: int) -> int:
        """The global rank ``offset`` steps along ``axes`` taken as one
        ring (row-major over them, wrapping around)."""
        live = self._live(axes)
        k = (self.index(live) + offset) % self.size(live)
        coords = dict(self.coords)
        for a in reversed(live):
            coords[a] = k % self.shape[a]
            k //= self.shape[a]
        return self.rank_at(coords)

    # -- transport -----------------------------------------------------------

    def transport(self, t: torch.Tensor) -> str:
        if self.backend == "nccl":
            return "nccl"
        return "gloo via host" if t.is_cuda else "gloo"

    def _start(self, on_card: bool) -> float:
        """An op's start on the host clock.  Under gloo a card rank first
        waits for its queued kernels, which the op's host copy would wait
        for anyway, so that the op's seconds are its own."""
        if on_card and self.backend != "nccl":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _staged(self, t: torch.Tensor, reuse: bool = False) -> torch.Tensor:
        """The buffer an op runs on: ``t`` itself if it can (contiguous,
        and not CUDA under gloo), else a contiguous copy; a CUDA tensor
        under gloo is copied into pinned host memory, with ``reuse`` into
        a buffer this mesh keeps for its shape (an op that is done with
        it when it returns)."""
        if self.backend == "nccl" or not t.is_cuda:
            return t if t.is_contiguous() else t.contiguous()
        if not reuse:
            return t.detach().to("cpu", memory_format=torch.contiguous_format)
        buf = self._pinned_buffer(t.shape, t.dtype)
        buf.copy_(t)
        return buf

    def _pinned_buffer(self, shape, dtype) -> torch.Tensor:
        """A pinned host buffer this mesh keeps for (dtype, size), viewed
        as ``shape``; an op that uses it is done with it when it returns
        (a synchronous copy out, or the reduce)."""
        key = (dtype, math.prod(shape))
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(key[1], dtype=dtype,
                                                  pin_memory=True)
        return buf.view(tuple(shape))

    def _record(self, op: str, t: torch.Tensor, t0: float) -> None:
        s = self.stats[(op, self.transport(t))]
        s.calls += 1
        s.seconds += time.perf_counter() - t0
        s.bytes += t.numel() * t.element_size()

    def reset_stats(self) -> None:
        self.stats.clear()

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """Reduce ``t`` in place over ``axes`` ("sum" or "max"); returns
        ``t``.  A no-op over one rank."""
        g = self.group(axes)
        if g is None:
            return t
        t0 = self._start(t.is_cuda)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = self._staged(t, reuse=True)
        if buf.dtype == torch.bfloat16 and self.backend != "nccl":
            wide = buf.to(torch.float32)      # gloo reduces f32: one round
            dist.all_reduce(wide, rop, group=g)
            buf.copy_(wide)
        else:
            dist.all_reduce(buf, rop, group=g)
        if buf is not t:
            t.copy_(buf)
        self._record(f"all_reduce_{op}", t, t0)
        return t

    def all_gather(self, t: torch.Tensor, axes) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axes`` (equal shapes), in row-major
        order over the axes."""
        g = self.group(axes)
        if g is None:
            return [t]
        t0 = self._start(t.is_cuda)
        buf = self._staged(t).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.size(axes))]
        dist.all_gather(parts, buf, group=g)
        parts = [p.to(t.device) for p in parts]
        self._record("all_gather", t, t0)
        return parts

    def gather(self, t: torch.Tensor, axes) -> Optional[List[torch.Tensor]]:
        """Every rank's ``t`` along ``axes`` (equal shapes), in row-major
        order, on the rank at index 0 along them (on the host under
        gloo); None on the others.  Point-to-point: gloo's sends move
        large buffers some 3x faster than its gather."""
        live = self._live(axes)
        if not live:
            return [t]
        t0 = self._start(t.is_cuda)
        buf = self._staged(t)
        members = [self.rank_at({**self.coords, **dict(zip(live, c))})
                   for c in itertools.product(*(range(self.shape[a])
                                                for a in live))]
        if members[0] != self.rank:
            dist.send(buf, members[0], tag=GATHER_TAG)
            self._record("gather", t, t0)
            return None
        parts = [buf]
        for src in members[1:]:
            part = torch.empty_like(buf)
            dist.recv(part, src, tag=GATHER_TAG)
            parts.append(part)
        self._record("gather", t, t0)
        return parts

    def send(self, t: torch.Tensor, axis: str, offset: int, tag: int = 0):
        """Start sending ``t`` to the rank ``offset`` steps along ``axis``;
        returns a handle whose ``wait()`` ends the send (the buffer stays
        alive with it)."""
        return self._send(t, self.neighbour(axis, offset), tag)

    def _send(self, t: torch.Tensor, peer: int, tag: int):
        t0 = self._start(t.is_cuda)
        buf = self._staged(t).contiguous()
        work = dist.isend(buf, peer, tag=tag)
        self._record("send", t, t0)
        return _Pending(self, work, buf, t)

    def recv(self, shape, dtype, axis: str, offset: int,
             tag: int = 0) -> torch.Tensor:
        """Receive a tensor from the rank ``offset`` steps along ``axis``
        onto this rank's device (blocking)."""
        return self._recv(shape, dtype, self.neighbour(axis, offset), tag)

    def _recv(self, shape, dtype, peer: int, tag: int) -> torch.Tensor:
        t0 = self._start(self.device.type == "cuda")
        host = self.backend != "nccl" and self.device.type == "cuda"
        buf = self._pinned_buffer(shape, dtype) if host else torch.empty(
            shape, dtype=dtype, device=self.device)
        dist.recv(buf, peer, tag=tag)
        out = buf.to(self.device) if host else buf
        self._record("recv", out, t0)
        return out

    def shift(self, t: torch.Tensor, axes, offset: int = 1) -> torch.Tensor:
        """One hop of a ring over ``axes`` (row-major over them, wrapping):
        send ``t`` to the rank ``offset`` steps on and return the tensor of
        the same shape and dtype received from the rank ``offset`` steps
        back.  ``t`` itself over one rank."""
        if self.size(axes) == 1:
            return t
        pending = self._send(t, self._ring_rank(axes, offset), SHIFT_TAG)
        out = self._recv(t.shape, t.dtype, self._ring_rank(axes, -offset),
                         SHIFT_TAG)
        pending.wait()
        return out


class _Pending:
    def __init__(self, mesh, work, buf, orig):
        self.mesh, self.work, self.buf, self.orig = mesh, work, buf, orig

    def wait(self) -> None:
        t0 = time.perf_counter()
        self.work.wait()
        self.mesh._record("send_wait", self.orig, t0)


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int, backend: str) -> str:
    """Where rank ``rank`` computes: the CPU, its own card under nccl, or
    the one shared card under gloo."""
    if torch.device(device).type == "cpu":
        return "cpu"
    return f"cuda:{rank}" if backend == "nccl" else "cuda:0"


def _rank_main(rank: int, world: int, port: int, device: str,
               backend: str, threads: int, fn: Callable, args: tuple,
               results) -> None:
    started = time.time()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      GLOO_SOCKET_IFNAME="lo", RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    dev = rank_device(device, rank, backend)
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=rank, world_size=world,
                                timeout=TIMEOUT)
        ready = time.time()
        out = fn(dev, *args)
        results.put((rank, True, (out, (started, ready, time.time()))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_ranks(fn: Callable, n: int, *args, device="cpu",
                 timeout: float = 600.0, threads=1,
                 timings: Optional[Dict[str, Any]] = None) -> List[Any]:
    """Run ``fn(rank_device, *args)`` in ``n`` spawned ranks over one
    process group; return the ranks' results in rank order.  ``device``
    and ``threads`` (torch's intra-op threads) are one for every rank or
    a list, one a rank.

    ``fn`` and ``args`` must pickle (a module-level function), and so
    must the results, by value: return numpy arrays, not tensors (a
    tensor is passed by a file descriptor that dies with its rank).  The
    backend is ``pick_backend(device, n)``.  Any rank that raises or
    exits non-zero, or a call past ``timeout`` seconds, stops every rank
    and raises here with the failing rank's traceback.  ``timings``, if
    given, gets the wall clock of the call's start, each rank's start,
    process group and function end, each result's arrival, and the end
    of the joins."""
    backend = pick_backend(device, n)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    began = time.time()
    devices = [device] * n if isinstance(device, str) else list(device)
    nthreads = [threads] * n if isinstance(threads, int) else list(threads)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, devices[r], backend, nthreads[r],
                               fn, args, results), daemon=False)
             for r in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n and error is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    error = f"rank {dead[0][0]} exited with {dead[0][1]}"
                elif time.monotonic() > deadline:
                    error = f"ranks did not finish within {timeout:.0f} s"
                continue
            if ok:
                got[rank] = out + (time.time(),)
            else:
                error = f"rank {rank} raised:\n{out}"
    finally:
        if error is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(f"launch_ranks({getattr(fn, '__name__', fn)}, "
                           f"{n}, {backend}): {error}")
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited non-zero: {bad}")
    if timings is not None:
        timings.update(began=began, joined=time.time(), ranks=[
            dict(zip(("started", "ready", "done", "arrived"),
                     got[r][1] + (got[r][2],))) for r in range(n)])
    return [got[r][0] for r in range(n)]
