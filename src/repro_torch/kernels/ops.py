"""Public ops of the BP kernels: ``oisma_matmul`` (fused and unfused),
``oisma_mlp``, their straight-through trainable forms
``oisma_matmul_ste`` and ``oisma_mlp_ste``, ``prepare_bp_weight``,
``bp_matmul_codes`` and ``popcount_accumulate``.

``oisma_matmul`` is what ``dense`` dispatches to under
``matmul_mode="bp8_fused"``: two absmax scans (x and, for a real weight,
y), each floored at f32 ``tiny`` in the same launch, then one fused
kernel that encodes both tiles on the fly, multiplies and rescales.  A
real weight reaches the kernels as it is stored, f32 or bf16 (the
model's), and is never cast: the kernels widen bf16 in registers, which
is exact, so the result is bitwise that of the f32 cast.  x is cast to
f32 once.  ``impl="unfused"`` runs the reference pipeline instead, on
the weight as stored too: the same two scales, a BP quantise kernel per
operand (int8 codes through device memory), the codes matmul kernel,
then the rescale ``acc * ((sx * sy) * 0.1)`` in torch.  Every float
expression matches, so the two are bitwise equal.

The kernels mask their ragged edges, so no operand is padded and the
reference's block-size arguments are not carried; zero padding would add
nothing to the integer accumulation, so the results equal the
reference's, which pads to its block grid.  A weight encoded once by
``prepare_bp_weight`` (int8 codes plus its scale) feeds the fused kernel
as ``y``.

``oisma_matmul(impl="fused")`` and ``oisma_mlp`` count each call they
make eagerly in ``kernels.metrics`` (the reference's ``kernels.*``
series), with the analytic traffic of ``kernels.traffic`` at the Hopper
kernels' tiles; a call made while a CUDA graph is warmed up or captured
is not counted, and a replay calls no op.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.quantize import quantize_bp
from repro_torch.kernels import bp_matmul as _k
from repro_torch.kernels import fused as _f
from repro_torch.kernels import metrics as _metrics
from repro_torch.kernels import traffic as _traffic
from repro_torch.kernels.ref import to_codes

_TINY = float(torch.finfo(torch.float32).tiny)


def _scale(x: torch.Tensor) -> torch.Tensor:
    return _f.absmax(x, _TINY)


#: a function that reduces a (n,) f32 tensor of scales in place across
#: ranks (``dist.tp.global_scales``), or None; process-wide, since
#: autograd recomputes a remat'd layer on a thread of its own
_REDUCE_SCALES = [None]


@contextlib.contextmanager
def reduced_scales(reduce: Callable[[torch.Tensor], torch.Tensor]):
    """Pass every scale the ops take through ``reduce`` (one call for an
    op's scales) while the block runs, forward and backward."""
    prev = _REDUCE_SCALES[0]
    _REDUCE_SCALES[0] = reduce
    try:
        yield
    finally:
        _REDUCE_SCALES[0] = prev


def _scales(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor's absmax scale, (1, 1) f32 floored at tiny; reduced
    across ranks in one call when ``reduced_scales`` is active."""
    out = tuple(_scale(t) for t in ts)
    reduce = _REDUCE_SCALES[0]
    if reduce is None:
        return out
    flat = torch.cat([s.reshape(1) for s in out])
    reduce(flat)
    return tuple(flat[i:i + 1].reshape(1, 1) for i in range(len(ts)))


def _weight(w: torch.Tensor) -> torch.Tensor:
    """A real weight as the kernels read it: f32 and bf16 as they are,
    any other float type cast to f32."""
    if w.dtype not in (torch.float32, torch.bfloat16):
        w = w.to(torch.float32)
    return w.contiguous()


def prepare_bp_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode a (K, N) weight once: (int8 sign*level codes, (1, 1) scale)."""
    q = quantize_bp(w.to(torch.float32))
    return to_codes(q), q.scale.reshape(1, 1)


def bp_matmul_codes(x_codes: torch.Tensor,
                    y_codes: torch.Tensor) -> torch.Tensor:
    """The codes matmul: int8 sign*level codes in, the integer
    accumulation out as f32 (unscaled)."""
    if x_codes.shape[-1] != y_codes.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(x_codes.shape)} @ "
                         f"{tuple(y_codes.shape)}")
    return _k.bp_matmul(x_codes.contiguous(), y_codes.contiguous())


def oisma_matmul_unfused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference pipeline: quantise -> codes matmul -> rescale, in the
    fused epilogue's association ``acc * ((sx * sy) * 0.1)``."""
    x = x.to(torch.float32).contiguous()
    y = _weight(y)
    sx, sy = _scales(x, y)
    acc = _k.bp_matmul(_k.bp_quantize(x, sx), _k.bp_quantize(y, sy))
    return acc * ((sx * sy) * 0.1)


@functools.lru_cache(maxsize=1024)
def _traffic_counts(kernel: str, m: int, k: int, n: int,
                    coded: bool) -> Tuple[int, int]:
    """(elements padded to the tiles, bytes saved against the unfused
    pipeline) of a fused call at the Hopper kernels' tiles."""
    tiles = _traffic.hopper_tiles(m)
    if kernel == "fused_matmul":
        fused = _traffic.matmul_traffic_fused(m, k, n, weights_coded=coded,
                                              **tiles)
        unfused = _traffic.matmul_traffic_unfused(m, k, n, **tiles)
    else:
        fused = _traffic.mlp_traffic_fused(m, k, n, weights_coded=coded,
                                           **_traffic.hopper_tiles(m, 2))
        unfused = _traffic.mlp_traffic_unfused(m, k, n, **tiles)
    return fused["padded_elements"], unfused["total"] - fused["total"]


def _record(kernel: str, x: torch.Tensor, k: int, n: int,
            coded: bool = False) -> None:
    if not _metrics.recording() or (
            x.is_cuda and torch.cuda.is_current_stream_capturing()):
        return  # a graph's warm-up or capture: counted at eager entry only
    padded, saved = _traffic_counts(kernel, x.shape[0], k, n, coded)
    _metrics.record_call(kernel, padded_elements=padded, bytes_saved=saved)


def oisma_matmul(x: torch.Tensor, y: torch.Tensor, *,
                 y_scale: Optional[torch.Tensor] = None,
                 impl: str = "fused") -> torch.Tensor:
    """OISMA-simulated ``x @ y`` for 2-D operands; ``y`` real (K, N), read
    as stored if f32 or bf16, or int8 codes from ``prepare_bp_weight``
    (then ``y_scale`` is needed).
    ``impl``: "fused" (one kernel) or "unfused" (the reference pipeline,
    real ``y`` only)."""
    if x.shape[-1] != y.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if impl == "unfused":
        if not torch.is_floating_point(y):
            raise ValueError("impl='unfused' takes real weights")
        return oisma_matmul_unfused(x, y)
    if impl != "fused":
        raise ValueError(f"unknown impl {impl!r}")
    _record("fused_matmul", x, y.shape[0], y.shape[1], y.dtype == torch.int8)
    x = x.to(torch.float32).contiguous()
    if y.dtype == torch.int8:
        if y_scale is None:
            raise ValueError("coded y needs y_scale (see prepare_bp_weight)")
        y = y.contiguous()
        sy = y_scale.to(torch.float32).reshape(1, 1).contiguous()
        (sx,) = _scales(x)
    elif torch.is_floating_point(y):
        y = _weight(y)
        sx, sy = _scales(x, y)
    else:
        raise TypeError(f"y must be real or int8 codes, not {y.dtype}")
    return _f.fused_bp_matmul(x, y, sx, sy)


def oisma_mlp(x: torch.Tensor, w_up: torch.Tensor, w_gate: torch.Tensor, *,
              act: str = "silu") -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)``, both BP-fused in one kernel; real
    weights read as stored if f32 or bf16."""
    m, k = x.shape
    if k != w_up.shape[0] or w_gate.shape != w_up.shape:
        raise ValueError(f"mlp shapes: {tuple(x.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_gate.shape)}")
    _record("fused_mlp", x, k, w_up.shape[1])
    x = x.to(torch.float32).contiguous()
    up, gate = _weight(w_up), _weight(w_gate)
    return _f.fused_mlp(x, up, gate, *_scales(x, up, gate), act=act)


# ---------------------------------------------------------------------------
# straight-through wrappers (trainable dispatch targets)
# ---------------------------------------------------------------------------

class _MatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return oisma_matmul(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gf = g.to(torch.float32)
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (gf @ y.to(torch.float32).T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gy = (x.to(torch.float32).T @ gf).to(y.dtype)
        return gx, gy


def oisma_matmul_ste(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``oisma_matmul`` forward (the kernels, on the weight as stored);
    the gradients of the plain f32 matmul (straight-through), each in its
    input's dtype, as the reference's f32 gradient passes back through
    ``astype``.  Under ``torch.inference_mode`` nothing is recorded."""
    return _MatmulSTE.apply(x, y)


class _MlpSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_up, w_gate, act):
        ctx.save_for_backward(x, w_up, w_gate)
        ctx.act = act
        return oisma_mlp(x, w_up, w_gate, act=act)

    @staticmethod
    def backward(ctx, g):
        # the VJP of the plain f32 gated MLP act(x @ w_gate) * (x @ w_up)
        from repro_torch.models.layers import activation
        x, w_up, w_gate = ctx.saved_tensors
        xf = x.to(torch.float32)
        wu, wg = w_up.to(torch.float32), w_gate.to(torch.float32)
        gf = g.to(torch.float32)
        u = xf @ wu
        with torch.enable_grad():
            pre = (xf @ wg).requires_grad_()
            a = activation(pre, ctx.act)
            (d_gate,) = torch.autograd.grad(a, pre, gf * u)
        d_up = gf * a.detach()
        grads = [None, None, None, None]
        if ctx.needs_input_grad[0]:
            grads[0] = (d_up @ wu.T + d_gate @ wg.T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            grads[1] = (xf.T @ d_up).to(w_up.dtype)
        if ctx.needs_input_grad[2]:
            grads[2] = (xf.T @ d_gate).to(w_gate.dtype)
        return tuple(grads)


def oisma_mlp_ste(x: torch.Tensor, w_up: torch.Tensor, w_gate: torch.Tensor,
                  *, act: str = "silu") -> torch.Tensor:
    """``oisma_mlp`` forward (one fused kernel); the gradients of the
    plain f32 gated MLP (straight-through), each in its input's dtype."""
    return _MlpSTE.apply(x, w_up, w_gate, act)


def popcount_accumulate(bits: torch.Tensor) -> torch.Tensor:
    """Row popcount of a 2-D 0/1 matrix by the accumulation-periphery
    kernel, as (R,) int32 (any R and C: nothing is padded)."""
    return _k.popcount_accumulate(bits.contiguous())
