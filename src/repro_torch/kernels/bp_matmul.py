"""Wrappers of the unfused pipeline's three kernels: the BP quantise, the
codes matmul and the accumulation periphery (row popcount).

Each replaces a Pallas program of ``repro/kernels/bp_matmul.py`` (the
CUDA sources say how).  For tensors on the CPU the wrapper runs the plain
version from ``ref.py``; for CUDA tensors it checks device, dtype, shape
and contiguity, allocates its output with ``torch.empty`` (the codes
matmul needs no workspace: its K splits add into the output), launches
on the current stream and counts the launch.  Nothing falls back.  The
kernels mask their ragged edges, so no operand is padded and no block
size is taken.
"""
from __future__ import annotations

import torch

from repro_torch.core.bp import packed_thresholds
from repro_torch.kernels.build import KINDS, launch, on_cuda, require, stream
from repro_torch.kernels.fused import _require_scale
from repro_torch.kernels.ref import (bp_matmul_ref, bp_quantize_ref,
                                     popcount_accumulate_ref)

#: byte types the popcount kernel sums, and whether each is signed
_BYTE_TYPES = {torch.int8: True, torch.uint8: False, torch.bool: False}

__all__ = ["bp_matmul", "bp_quantize", "popcount_accumulate",
           "popcount_lanes", "bp_matmul_ref", "bp_quantize_ref",
           "popcount_accumulate_ref"]


def bp_matmul(x_codes: torch.Tensor, y_codes: torch.Tensor) -> torch.Tensor:
    """Signed BP8 matmul of int8 sign*level codes, x (M, K) right-biased
    and y (K, N) left-biased: the integer accumulation as (M, N) f32 (no
    1/10, no scales)."""
    if not on_cuda(x_codes, y_codes):
        return bp_matmul_ref(x_codes, y_codes)
    require(x_codes, "x_codes", torch.int8, 2)
    require(y_codes, "y_codes", torch.int8, 2)
    m, k = x_codes.shape
    if y_codes.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(x_codes.shape)} @ "
                         f"{tuple(y_codes.shape)}")
    n = y_codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    if m and n:
        launch("bp_matmul", x_codes.data_ptr(), y_codes.data_ptr(),
               out.data_ptr(), m, k, n,
               packed_thresholds("right"), packed_thresholds("left"), stream())
    return out


def bp_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 or bf16 values and one f32 scale -> int8 codes
    ``sign(x) * clip(round(|x| / scale * 10), 0, 9)`` of each element's
    f32 value, x's shape."""
    if not on_cuda(x, scale):
        return bp_quantize_ref(x, scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    require(x, "x", x.dtype, x.dim())
    _require_scale(scale, "scale")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        launch("bp_quantize", x.data_ptr(), KINDS[x.dtype], scale.data_ptr(),
               out.data_ptr(), x.numel(), stream())
    return out


def popcount_lanes(c: int) -> int:
    """Lanes of a warp that sum one row of ``c`` bytes in the popcount
    kernel: ``c / 16`` (one 16-byte load a lane) as a power of two, at
    least 1 and at most 32; a warp holds ``32 / lanes`` rows."""
    return 1 << min(max(c // 16, 1).bit_length() - 1, 5)


def popcount_accumulate(bits: torch.Tensor) -> torch.Tensor:
    """(R, C) bytes (int8, uint8 or bool) -> (R,) int32 row sums."""
    if not on_cuda(bits):
        return popcount_accumulate_ref(bits)
    if bits.dtype not in _BYTE_TYPES:
        raise TypeError(f"bits: expected int8, uint8 or bool, got {bits.dtype}")
    require(bits, "bits", bits.dtype, 2)
    r, c = bits.shape
    out = torch.empty((r,), dtype=torch.int32, device=bits.device)
    if r:
        launch("popcount", bits.data_ptr(), int(_BYTE_TYPES[bits.dtype]),
               out.data_ptr(), r, c, popcount_lanes(c), stream())
    return out
