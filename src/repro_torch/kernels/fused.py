"""Wrappers of the three BP kernels: absmax, fused matmul, fused MLP.

Each replaces a Pallas program of ``repro/kernels/fused.py`` (the CUDA
sources say how).  For tensors on the CPU the wrapper runs the plain
version from ``ref.py``; for CUDA tensors it checks device, dtype, shape
and contiguity, allocates its output (and the BP kernels' int32
workspace) with ``torch.empty``, launches on the current stream and
counts the launch.  Nothing falls back.

The kernels read a weight in the dtype it is stored in: f32, bf16 (the
model's), or int8 sign*level codes from ``prepare_bp_weight``; absmax
reads f32 or bf16.  Widening bf16 to f32 is exact, so a bf16 weight gives
bitwise what its f32 cast gives.
"""
from __future__ import annotations

import torch

from repro_torch.core.bp import packed_thresholds
from repro_torch.kernels.build import (KINDS, launch, library, on_cuda,
                                      require, stream)
from repro_torch.kernels.ref import absmax_ref, fused_matmul_ref, fused_mlp_ref

ACTIVATIONS = {"silu": 0, "gelu": 1, "relu": 2}

__all__ = ["absmax", "fused_bp_matmul", "fused_mlp", "absmax_ref",
           "fused_matmul_ref", "fused_mlp_ref"]


def _require_scale(s: torch.Tensor, name: str) -> None:
    if s.dtype != torch.float32 or s.numel() != 1 or not s.is_contiguous():
        raise ValueError(f"{name}: expected one contiguous f32 value, got "
                         f"{s.dtype} {tuple(s.shape)}")


def absmax(x: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """``max(max|x|, floor)`` of an f32 or bf16 array as a (1, 1) f32, in
    one launch.  ``floor=0.0`` is the Pallas kernel's function."""
    if not on_cuda(x):
        return absmax_ref(x, floor)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    require(x, "x", x.dtype, x.dim())
    if x.numel() == 0:
        raise ValueError("absmax of an empty tensor")
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    launch("absmax", x.data_ptr(), KINDS[x.dtype], x.numel(), float(floor),
           out.data_ptr(), stream())
    return out


def _check_weight(w: torch.Tensor, name: str, k: int) -> int:
    """The weight's kind for the C entry points: f32, bf16 or int8 codes."""
    if w.dtype not in KINDS:
        raise TypeError(f"{name}: expected float32, bfloat16 or int8 codes, "
                        f"got {w.dtype}")
    require(w, name, w.dtype, 2)
    if w.shape[0] != k:
        raise ValueError(f"{name}: contraction mismatch, K={k} vs "
                         f"{tuple(w.shape)}")
    return KINDS[w.dtype]


def fused_bp_matmul(x: torch.Tensor, y: torch.Tensor, x_scale: torch.Tensor,
                    y_scale: torch.Tensor) -> torch.Tensor:
    """OISMA ``x @ y`` with the scales given: x (M, K) f32; y (K, N) f32,
    bf16 or int8 sign*level codes; scales one f32 each.  Returns (M, N)
    f32."""
    if not on_cuda(x, y, x_scale, y_scale):
        return fused_matmul_ref(x, y, x_scale, y_scale)
    require(x, "x", torch.float32, 2)
    m, k = x.shape
    kind = _check_weight(y, "y", k)
    _require_scale(x_scale, "x_scale")
    _require_scale(y_scale, "y_scale")
    n = y.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        words = library().oisma_fused_matmul_workspace(m, k, n, kind)
        ws = torch.empty((words,), dtype=torch.int32, device=x.device)
        launch("fused_matmul", x.data_ptr(), y.data_ptr(), kind,
               x_scale.data_ptr(), y_scale.data_ptr(), out.data_ptr(),
               ws.data_ptr(), m, k, n, packed_thresholds("right"),
               packed_thresholds("left"), stream())
    return out


def fused_mlp(x: torch.Tensor, w_up: torch.Tensor, w_gate: torch.Tensor,
              x_scale: torch.Tensor, up_scale: torch.Tensor,
              gate_scale: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` over BP-encoded operands: x (M, K)
    f32; w_up, w_gate (K, F) of one kind: f32, bf16 or int8 codes.  At
    most two launches: the workspace's memset when K is split, then the
    tiles."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if not on_cuda(x, w_up, w_gate, x_scale, up_scale, gate_scale):
        return fused_mlp_ref(x, w_up, w_gate, act, x_scale, up_scale,
                             gate_scale)
    require(x, "x", torch.float32, 2)
    m, k = x.shape
    kind = _check_weight(w_up, "w_up", k)
    if _check_weight(w_gate, "w_gate", k) != kind or \
            w_gate.shape != w_up.shape:
        raise ValueError(f"w_up {w_up.dtype} {tuple(w_up.shape)} and w_gate "
                         f"{w_gate.dtype} {tuple(w_gate.shape)} must agree")
    for s, name in ((x_scale, "x_scale"), (up_scale, "up_scale"),
                    (gate_scale, "gate_scale")):
        _require_scale(s, name)
    f = w_up.shape[1]
    out = torch.empty((m, f), dtype=torch.float32, device=x.device)
    if m and f:
        words = library().oisma_fused_mlp_workspace(m, k, f, kind)
        ws = torch.empty((words,), dtype=torch.int32, device=x.device)
        launch("fused_mlp", x.data_ptr(), w_up.data_ptr(), w_gate.data_ptr(),
               kind, x_scale.data_ptr(), up_scale.data_ptr(),
               gate_scale.data_ptr(), out.data_ptr(), ws.data_ptr(), m, k, f,
               ACTIVATIONS[act], packed_thresholds("right"),
               packed_thresholds("left"), stream())
    return out
