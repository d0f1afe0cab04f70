"""Pipeline parallelism over the mesh's "stage" axis.

The reference's ``repro.dist.pipeline`` on the port's meshes.  The model's
layer stack is split into S *stages*, one per rank along "stage"; the
batch into M *microbatches*.  Each stage is one group of ranks (its
"data" x "model" ranks); activations and their gradients go between
neighbouring stages by point-to-point sends.

* The pure parts are the reference's: ``stack_stages`` /
  ``unstack_stages`` / ``stack_stages_padded`` (a depth the stage count
  does not divide is padded with identity layers at the tail, marked by
  ``valid``), ``bubble_fraction``, and the ``PipelineSchedule`` timetables
  ``gpipe_schedule`` and ``one_f_one_b_schedule`` (what every stage does
  at every tick).  ``stage_layers`` is the padded split as a range: the
  stage's real layers, which the port runs, skipping the padding (an
  identity).
* ``pipeline_apply`` is the GPipe forward: stage 0 feeds microbatch t at
  tick t, each stage sends its output on, the last stage keeps the
  outputs, which every stage gets back (the reference's psum).
* ``pipeline_grads`` is the training executor.  Each stage runs its ops
  in the schedule's tick order (GPipe: every forward, then every
  backward; 1F1B: warm-up forwards, then one forward and one backward
  in turn, then the cool-down backwards).  A forward receives its
  activation from the stage before (stage 0 makes it), runs the stage
  and sends the output on; the last stage turns it into its part of the
  loss.  A backward receives the output's gradient from the stage after
  (the last stage starts from its loss part), runs
  ``torch.autograd.grad`` on the stage that made the forward, adds the
  parameters' gradients into f32 buffers and sends the input's gradient
  back.  Sends are asynchronous and receives block, so a stage waits
  only for what its next op needs, as the timetable says.

Bubble model (both schedules): S - 1 of the M + S - 1 ticks of each
direction are fill or drain, ``bubble_fraction(S, M) = (S - 1) / (M +
S - 1)``.  1F1B keeps at most min(S, M) microbatches' activations on a
stage, GPipe M.

Nothing here touches a device or a process group at import.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def stack_stages(params: Any, num_stages: int) -> Any:
    """(L, ...) -> (S, L // S, ...) on every leaf; L must divide."""
    def reshape(p):
        L = p.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers not divisible into {num_stages} "
                             "stages")
        return p.reshape((num_stages, L // num_stages) + tuple(p.shape[1:]))
    return _tree_map(reshape, params)


def unstack_stages(params: Any) -> Any:
    """Inverse of ``stack_stages``: (S, L // S, ...) -> (L, ...)."""
    return _tree_map(lambda p: p.reshape((p.shape[0] * p.shape[1],)
                                         + tuple(p.shape[2:])), params)


def stack_stages_padded(params: Any, num_stages: int
                        ) -> Tuple[Any, torch.Tensor]:
    """(L, ...) -> (S, ceil(L / S), ...) padded with zero layers at the
    tail, and ``valid`` (S, L_per) bool marking the real layers."""
    L = _first_leaf(params).shape[0]
    per = -(-L // num_stages)
    pad = num_stages * per - L

    def reshape(p):
        if p.shape[0] != L:
            raise ValueError(f"leaf of {p.shape[0]} layers, expected {L}")
        if pad:
            p = torch.cat([p, torch.zeros((pad,) + tuple(p.shape[1:]),
                                          dtype=p.dtype, device=p.device)])
        return p.reshape((num_stages, per) + tuple(p.shape[1:]))

    valid = torch.arange(num_stages * per).reshape(num_stages, per) < L
    return _tree_map(reshape, params), valid


def stage_layers(num_layers: int, num_stages: int,
                 stage: int) -> Tuple[int, int]:
    """[lo, hi): the real layers of ``stage`` in the padded split (its
    padding, an identity, is not run)."""
    per = -(-num_layers // num_stages)
    lo = min(num_layers, stage * per)
    return lo, min(num_layers, lo + per)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the pipeline: (S - 1) / (M + S - 1); 0 for S = 1."""
    s, m = num_stages, num_microbatches
    if s <= 1:
        return 0.0
    return (s - 1) / (m + s - 1)


# ---------------------------------------------------------------------------
# timetables (the reference's)
# ---------------------------------------------------------------------------

#: per-(tick, stage) op codes in a schedule table
IDLE, FORWARD, BACKWARD = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """What every stage does at every tick: ``ops[t, i]`` is IDLE /
    FORWARD / BACKWARD and ``mbs[t, i]`` its microbatch ((T, S) each)."""
    name: str
    num_stages: int
    num_microbatches: int
    ops: np.ndarray
    mbs: np.ndarray

    @property
    def ticks(self) -> int:
        return self.ops.shape[0]

    @property
    def idle_fraction(self) -> float:
        """Fraction of (tick, stage) slots doing no F or B work."""
        return float((self.ops == IDLE).mean())

    def peak_activation_slots(self) -> int:
        """Most forward activations a stage holds at once: a microbatch
        from its FORWARD until its BACKWARD (GPipe M, 1F1B min(S, M))."""
        peak = 0
        for i in range(self.num_stages):
            live, p = set(), 0
            for t in range(self.ticks):
                if self.ops[t, i] == FORWARD:
                    live.add(self.mbs[t, i])
                    p = max(p, len(live))
                elif self.ops[t, i] == BACKWARD:
                    live.discard(self.mbs[t, i])
            peak = max(peak, p)
        return peak

    def stage_ops(self, stage: int) -> List[Tuple[int, int]]:
        """``stage``'s (op, microbatch) in tick order, idle ticks out."""
        return [(int(self.ops[t, stage]), int(self.mbs[t, stage]))
                for t in range(self.ticks) if self.ops[t, stage] != IDLE]


def gpipe_schedule(num_stages: int, num_microbatches: int
                   ) -> PipelineSchedule:
    """All forwards, then all backwards (reverse pipelining)."""
    S, M = num_stages, num_microbatches
    T = 2 * (M + S - 1)
    ops = np.full((T, S), IDLE)
    mbs = np.zeros((T, S), int)
    for i in range(S):
        for m in range(M):
            ops[i + m, i] = FORWARD
            mbs[i + m, i] = m
            t = (M + S - 1) + (S - 1 - i) + m
            ops[t, i] = BACKWARD
            mbs[t, i] = m
    return PipelineSchedule("gpipe", S, M, ops, mbs)


def one_f_one_b_schedule(num_stages: int, num_microbatches: int
                         ) -> PipelineSchedule:
    """PipeDream-flush / Megatron non-interleaved 1F1B: stage i runs
    min(S-1-i, M) warm-up forwards, then F and B in turn, then the
    cool-down backwards, each op at the earliest tick after its input
    arrives (a neighbour's op at tick t is usable from t + 1)."""
    S, M = num_stages, num_microbatches
    seqs = []
    for i in range(S):
        w = min(S - 1 - i, M)
        seq = [("F", m) for m in range(w)]
        for m in range(w, M):
            seq.append(("F", m))
            seq.append(("B", m - w))
        for m in range(M - w, M):
            seq.append(("B", m))
        seqs.append(seq)
    f_done = [[None] * M for _ in range(S)]
    b_done = [[None] * M for _ in range(S)]
    pos = [0] * S
    ops_rows, mbs_rows = [], []
    t = 0
    while any(pos[i] < len(seqs[i]) for i in range(S)):
        row_op, row_mb = [], []
        for i in range(S):
            if pos[i] >= len(seqs[i]):
                row_op.append(IDLE)
                row_mb.append(0)
                continue
            op, m = seqs[i][pos[i]]
            if op == "F":
                ready = i == 0 or (f_done[i - 1][m] is not None
                                   and f_done[i - 1][m] < t)
            else:
                ready = i == S - 1 or (b_done[i + 1][m] is not None
                                       and b_done[i + 1][m] < t)
            row_op.append((FORWARD if op == "F" else BACKWARD)
                          if ready else IDLE)
            row_mb.append(m if ready else 0)
        for i in range(S):
            if row_op[i] == FORWARD:
                f_done[i][row_mb[i]] = t
                pos[i] += 1
            elif row_op[i] == BACKWARD:
                b_done[i][row_mb[i]] = t
                pos[i] += 1
        ops_rows.append(row_op)
        mbs_rows.append(row_mb)
        t += 1
        if t > 4 * (M + S) + 4:
            raise RuntimeError("1F1B list scheduler did not converge")
    return PipelineSchedule("1f1b", S, M, np.array(ops_rows),
                            np.array(mbs_rows))


SCHEDULES = {"gpipe": gpipe_schedule, "1f1b": one_f_one_b_schedule}


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_apply(stage_fn: Callable, x: torch.Tensor, mesh,
                   axis_name: str = "stage", *, with_aux: bool = False):
    """The GPipe forward over ``axis_name``: ``x`` is (M, B, ...) (read on
    stage 0; the other stages use its shape), ``stage_fn(act) -> act`` (or
    ``(act, aux)`` with ``with_aux``) runs this stage's layers, shape
    preserving.  Returns the (M, B, ...) outputs on every stage (and the
    aux summed over stages and microbatches).  No gradients."""
    S, s = mesh.size(axis_name), mesh.index(axis_name)
    M = x.shape[0]
    outs, aux_sum = [], torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    pending = []
    with torch.no_grad():
        for m in range(M):
            a = x[m] if s == 0 else mesh.recv(x.shape[1:], x.dtype,
                                              axis_name, -1, tag=m)
            res = stage_fn(a)
            out, aux = res if with_aux else (res, None)
            if aux is not None:
                aux_sum = aux_sum + aux.to(torch.float32)
            if s < S - 1:
                pending.append(mesh.send(out, axis_name, 1, tag=m))
            else:
                outs.append(out)
        for p in pending:
            p.wait()
        y = torch.stack(outs) if s == S - 1 else torch.zeros_like(x)
        mesh.all_reduce(y, axis_name)       # only the last stage's count
        mesh.all_reduce(aux_sum, axis_name)
    return (y, aux_sum) if with_aux else y


@dataclasses.dataclass
class StageTimes:
    """Host seconds of one stage's part of a flush: the whole, its
    forward and backward ops (each synchronised), and the waits for
    receives and sends."""
    total_s: float = 0.0
    forward_s: float = 0.0
    backward_s: float = 0.0
    recv_s: float = 0.0
    send_s: float = 0.0


def pipeline_grads(stage_fn: Callable, mesh, num_microbatches: int, *,
                   inputs: Sequence[torch.Tensor],
                   act_shape: Sequence[int], act_dtype,
                   first_fn: Callable, last_fn: Callable,
                   on_input_grad: Optional[Callable] = None,
                   aux_coef: float = 0.0, schedule: str = "1f1b",
                   axis_name: str = "stage"):
    """Pipelined forward and backward of one flush, in ``schedule``'s
    tick order.

    ``stage_fn(act, m) -> (act, aux or None)`` runs this stage's layers
    on microbatch m; ``first_fn(m)`` makes stage 0's input (a tensor that
    requires grad, whose gradient goes to ``on_input_grad(m, grad)``);
    ``last_fn(act, m)`` turns the last stage's output into its part of
    the loss (a scalar).  ``aux`` enters the loss times ``aux_coef``.
    ``inputs`` are this rank's leaves whose gradients are wanted.

    Returns ``(grads, loss, aux, times)``: f32 gradients of ``inputs``
    summed over the microbatches (None for a leaf the stage never used),
    the sum of the last stage's loss parts (0 elsewhere), this stage's
    aux summed over microbatches, and its ``StageTimes``."""
    S, s = mesh.size(axis_name), mesh.index(axis_name)
    M = num_microbatches
    first, last = s == 0, s == S - 1
    ops = SCHEDULES[schedule](S, M).stage_ops(s)
    inputs = list(inputs)
    grads: List[Optional[torch.Tensor]] = [None] * len(inputs)
    device = mesh.device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    aux_total = torch.zeros((), dtype=torch.float32, device=device)
    live: Dict[int, tuple] = {}
    pending = []
    times = StageTimes()
    coef = torch.tensor(aux_coef, dtype=torch.float32, device=device)
    t_flush = time.perf_counter()
    for op, m in ops:
        if op == FORWARD:
            if first:
                a = first_fn(m)
            else:
                t0 = time.perf_counter()
                a = mesh.recv(act_shape, act_dtype, axis_name, -1, tag=m)
                times.recv_s += time.perf_counter() - t0
                a.requires_grad_()
            t0 = time.perf_counter()
            out, aux = stage_fn(a, m)
            if aux is not None:
                aux_total = aux_total + aux.detach().to(torch.float32)
            if last:
                out = last_fn(out, m)
                loss = loss + out.detach().to(torch.float32)
            _sync(device)
            times.forward_s += time.perf_counter() - t0
            if not last:
                t0 = time.perf_counter()
                pending.append(mesh.send(out.detach(), axis_name, 1, tag=m))
                times.send_s += time.perf_counter() - t0
            live[m] = (a, out, aux)
        else:
            a, out, aux = live.pop(m)
            if last:
                g = None
            else:
                t0 = time.perf_counter()
                g = mesh.recv(act_shape, act_dtype, axis_name, 1,
                              tag=M + m)
                times.recv_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            outs, gouts = [out], [g]
            if aux is not None and aux.requires_grad and aux_coef:
                outs.append(aux)
                gouts.append(coef.to(aux.dtype))
            want = ([a] if a.requires_grad else []) + inputs
            got = torch.autograd.grad(outs, want, gouts, allow_unused=True)
            da = got[0] if a.requires_grad else None
            for i, gi in enumerate(got[len(want) - len(inputs):]):
                if gi is None:
                    continue
                gi = gi.to(torch.float32)
                grads[i] = gi if grads[i] is None else grads[i].add_(gi)
            _sync(device)
            times.backward_s += time.perf_counter() - t0
            if first:
                if on_input_grad is not None and da is not None:
                    on_input_grad(m, da)
            else:
                t0 = time.perf_counter()
                pending.append(mesh.send(da, axis_name, -1, tag=M + m))
                times.send_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in pending:
        p.wait()
    times.send_s += time.perf_counter() - t0
    times.total_s = time.perf_counter() - t_flush
    return grads, loss, aux_total, times
