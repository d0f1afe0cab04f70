"""Plain PyTorch versions of the kernels: the same functions, written as
tensor code.

The CPU tests hold them against the JAX reference, the wrappers run them
for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They never run on the card's main path.

The BP matmul here (``bp_matmul_ref``, on int8 sign*level codes) is an
f32 matmul over the 8x-expanded signed bitplanes.  Every plane product is
in {-1, 0, 1} and every partial sum an integer below 2**24 (|acc| <= 8K),
so it is exact in any summation order: the result is bitwise that of the
integer AND+popcount.  The fused matmul quantises both operands
(``bp_quantize_ref``), takes that product and scales it in the epilogue
as ``acc * ((sx * sy) * 0.1)`` in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.bp import NUM_LEVELS, plane_thresholds

_TINY = float(torch.finfo(torch.float32).tiny)
_K_CHUNK = 512          # K rows expanded at a time (bounds the 8x planes)


def absmax_ref(x: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """``max(max|x|, floor)`` as a (1, 1) f32 (``floor=0.0``: none)."""
    return torch.clamp_min(x.float().abs().amax().reshape(1, 1), floor)


def tensor_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor max-|x| scale floored at f32 tiny, as (1, 1)."""
    return absmax_ref(x, _TINY)


def bp_levels(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(|x| / scale * 10), 0, 9)`` in f32, half to even."""
    return torch.clamp(torch.round(x.abs() / scale * 10.0), 0.0,
                       float(NUM_LEVELS - 1))


def level_boundaries(scale: torch.Tensor) -> torch.Tensor:
    """(9,) f32: for level l = 1..9, the least f32 ``a >= 0`` whose
    ``bp_levels(a, scale)`` is l or more (NaN if no f32 reaches l).

    The level never decreases as |x| grows, so ``bp_levels(x) >= l`` iff
    ``|x| >= b_l``: the plain version of the kernels' bisection on the f32
    bit pattern, which runs the level's own division."""
    s = scale.to(torch.float32).reshape(())
    lv = torch.arange(1, NUM_LEVELS, dtype=torch.float32, device=s.device)
    lo = torch.zeros(lv.shape, dtype=torch.int32, device=s.device)
    hi = torch.full(lv.shape, 0x7F800000, dtype=torch.int32, device=s.device)
    for _ in range(31):             # the range holds 2**31 bit patterns
        mid = lo + (hi - lo) // 2
        ok = bp_levels(mid.view(torch.float32), s) >= lv
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    b = hi.view(torch.float32)
    return torch.where(bp_levels(b, s) >= lv, b, torch.nan)


def plane_boundaries(scale: torch.Tensor, which: str) -> torch.Tensor:
    """(8,) f32: plane p of a value is set iff ``|x| >= boundary[p]``, the
    boundary of the plane's level threshold under ``scale``."""
    t = torch.tensor(plane_thresholds(which), dtype=torch.long)
    b = torch.cat([level_boundaries(scale),
                   torch.full((1,), torch.nan, device=scale.device)])
    return b[(t - 1).clamp(0, NUM_LEVELS - 1).to(scale.device)]


def bf16_plane_boundaries(scale: torch.Tensor, which: str) -> torch.Tensor:
    """(8,) int32: ``plane_boundaries`` as bf16 bit patterns, rounded up,
    so that for a bf16 value v, plane p is set iff ``bits(|v|) >=
    result[p]`` (0x8000, above every |v|, where no value reaches the
    plane).  The plain version of the kernels' two-values-a-compare bf16
    encode (``bf16_boundary2`` in ``csrc/bp_mma.cuh``)."""
    b = plane_boundaries(scale, which)
    u = b.view(torch.int32)
    h = (u >> 16) + ((u & 0xFFFF) != 0).to(torch.int32)
    return torch.where(torch.isnan(b), 0x8000, h)


def bp_quantize_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes ``sign(x) * clip(round(|x| / scale * 10), 0, 9)`` of the
    f32 value of each element (a bf16 x is widened first, as the TPU
    kernel casts its tile)."""
    x = x.to(torch.float32)
    s = scale.to(torch.float32).reshape(())
    # bp_levels' ops in place: one f32 temporary instead of five
    lv = x.abs().div_(s).mul_(10.0).round_().clamp_(0.0, NUM_LEVELS - 1)
    return lv.mul_(torch.sign(x)).to(torch.int8)


def to_codes(q) -> torch.Tensor:
    """A ``BPQuantized`` -> int8 sign*level codes."""
    return q.sign.to(torch.int8) * q.levels.to(torch.int8)


def popcount_accumulate_ref(bits: torch.Tensor) -> torch.Tensor:
    """Row sums of a 2-D 0/1 (or any integer) matrix as int32."""
    return bits.to(torch.int32).sum(-1, dtype=torch.int32)


def _planes(codes: torch.Tensor, which: str, axis: int) -> torch.Tensor:
    """Signed bitplanes ``sign * (level >= threshold[p])`` of int8 codes as
    f32, the plane axis inserted at ``axis``: x's as (M, K, 8) and y's as
    (K, 8, N), so that both flatten, without a copy, to one contraction
    over (k, p)."""
    t = torch.tensor(plane_thresholds(which), dtype=codes.dtype,
                     device=codes.device)
    shape = [1] * (codes.dim() + 1)
    shape[axis] = -1
    sign = torch.sign(codes).to(torch.float32).unsqueeze(axis)
    return torch.where(codes.abs().unsqueeze(axis) >= t.reshape(shape), sign,
                       0.0)


def _scalar(s: torch.Tensor) -> torch.Tensor:
    return s.to(torch.float32).reshape(1, 1)


def bp_matmul_ref(x_codes: torch.Tensor,
                  y_codes: torch.Tensor) -> torch.Tensor:
    """Signed BP8 product of int8 sign*level codes (x right-biased, y
    left-biased): the integer accumulation as f32, unscaled."""
    m, k = x_codes.shape
    n = y_codes.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x_codes.device)
    for k0 in range(0, k, _K_CHUNK):
        xp = _planes(x_codes[:, k0:k0 + _K_CHUNK], "right", 2)
        yp = _planes(y_codes[k0:k0 + _K_CHUNK], "left", 1)
        acc += xp.reshape(m, -1) @ yp.reshape(-1, n)
    return acc


def fused_matmul_ref(x: torch.Tensor, y: torch.Tensor,
                     x_scale: Optional[torch.Tensor] = None,
                     y_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """OISMA ``x @ y``: x encoded right-biased, y left-biased (or given as
    int8 sign*level codes with ``y_scale``), integer plane products,
    f32 epilogue.  Scales left as None are the floored max-|.| of the
    operand, as the reference oracle computes them."""
    x = x.to(torch.float32)
    sx = tensor_scale(x) if x_scale is None else _scalar(x_scale)
    if torch.is_floating_point(y):
        y = y.to(torch.float32)
        sy = tensor_scale(y) if y_scale is None else _scalar(y_scale)
        y = bp_quantize_ref(y, sy)
    elif y_scale is None:
        raise ValueError("coded y needs y_scale")
    else:
        sy = _scalar(y_scale)
    return bp_matmul_ref(bp_quantize_ref(x, sx), y) * ((sx * sy) * 0.1)


def kernel_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The fused MLP's epilogue activation, in f32 (silu as
    ``g * (1 / (1 + exp(-g)))``, as the reference's logistic expands)."""
    if kind == "silu":
        return x * (1.0 / (1.0 + torch.exp(-x)))
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return torch.clamp_min(x, 0.0)
    raise ValueError(kind)


def fused_mlp_ref(x: torch.Tensor, w_up: torch.Tensor, w_gate: torch.Tensor,
                  act: str = "silu", x_scale: Optional[torch.Tensor] = None,
                  up_scale: Optional[torch.Tensor] = None,
                  gate_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)``, both as OISMA matmuls sharing
    x's scale."""
    sx = tensor_scale(x) if x_scale is None else x_scale
    u = fused_matmul_ref(x, w_up, sx, up_scale)
    g = fused_matmul_ref(x, w_gate, sx, gate_scale)
    return kernel_activation(g, act) * u


from repro_torch.kernels.attention import (  # noqa: E402  (re-export)
    bp8_decode_attention_ref, bp8_decode_attention_split_ref, dequantize_kv,
    quantize_kv)

__all__ = ["absmax_ref", "tensor_scale", "bp_levels", "level_boundaries",
           "plane_boundaries", "bf16_plane_boundaries", "bp_quantize_ref",
           "to_codes", "popcount_accumulate_ref", "bp_matmul_ref",
           "fused_matmul_ref", "fused_mlp_ref", "kernel_activation",
           "bp8_decode_attention_ref", "bp8_decode_attention_split_ref",
           "quantize_kv", "dequantize_kv"]
