"""Bent-Pyramid matrix multiplication in plain PyTorch: the reference's
three formulations of the OISMA matmul, and the form ``dense`` runs under
``matmul_mode="bp8"`` and ``"bp8_lowrank"``.

* ``bp_matmul_lut`` — one-hot contraction with the 10x10 product table,
  the oracle;
* ``bp_matmul_bitplane`` — popcount(AND(u, v)) == <u, v> for 0/1 vectors,
  so the product is one matmul over the 8x-wide bitplanes;
* ``bp_matmul_lowrank`` — the table factored as L @ R^T (rank 8 for the
  canonical datasets), an r-wide blow-up instead of 8.

The signed, scaled form ``bp_matmul`` quantises both operands with
``quantize_bp`` and carries the signs in the planes.  The products are
plain f32 matmuls, as the reference leaves them to XLA: the planes are
exact in {-1, 0, 1} and every sum an integer below 2**24, so the lut and
bitplane results are bitwise the reference's in any summation order
(``resolve_device`` keeps TF32 off).  The lowrank factors are not
integers, so its sums round in the order the matmul takes.

Scaling follows the reference as XLA compiles it.  Its source reads
``(c / 10) * (sx * sy)``; under ``jit`` XLA turns the division by a
constant into a multiply by 0.1 and folds the scalars first, computing
``c * ((sx * sy) * 0.1)`` (and ``c * 0.1`` in the level domain), which
parts from the eager expression in the last bit of about one output in
three.  The port computes the compiled form: it is what the reference's
model, trainer and server run, and it is the fused kernel's epilogue, so
``bp8`` and ``bp8_fused`` give the same bits.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bp
from repro_torch.core.quantize import quantize_bp
from repro_torch.device import device_constant

EFFECTIVE_BITS = bp.EFFECTIVE_BITS


@functools.lru_cache(None)
def _tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(right_bitplanes[10, 8], left_bitplanes[10, 8], lut[10, 10]), f32."""
    return (bp.bitstreams_bp8("right").astype(np.float32),
            bp.bitstreams_bp8("left").astype(np.float32),
            bp.mult_lut().astype(np.float32))


@functools.lru_cache(None)
def lut_factors(tol: float = 1e-6, rank: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(L[10, r], R[10, r], r) with L @ R.T == lut to float precision
    (exact rank when ``rank`` is None; else the SVD truncated to it)."""
    lut = _tables()[2].astype(np.float64)
    u, s, vt = np.linalg.svd(lut)
    r = int((s > s[0] * tol).sum()) if rank is None else int(rank)
    left = u[:, :r] * np.sqrt(s[:r])
    right = vt[:r, :].T * np.sqrt(s[:r])
    return left.astype(np.float32), right.astype(np.float32), r


def lut_rank() -> int:
    return lut_factors()[2]


@device_constant
def _table(name: str, dtype, device, rank: Optional[int] = None
           ) -> torch.Tensor:
    """One of the tables on ``device``, made once: "right" and "left" (the
    datasets' bitplanes), "lut", or "low_left" / "low_right" (the LUT's
    factors at ``rank``)."""
    if name in ("low_left", "low_right"):
        arr = lut_factors(rank=rank)[name == "low_right"]
    else:
        arr = _tables()[("right", "left", "lut").index(name)]
    return torch.as_tensor(arr, dtype=dtype, device=device)


def _fold(xa: torch.Tensor, ya: torch.Tensor, out_dtype) -> torch.Tensor:
    """(M, K, w) x (K, N, w) -> (M, N): one matmul over the K*w-wide
    contraction, in ``out_dtype``."""
    m, k, w = xa.shape
    n = ya.shape[1]
    xw = xa.to(out_dtype).reshape(m, k * w)
    yw = ya.to(out_dtype).permute(0, 2, 1).reshape(k * w, n)
    return torch.matmul(xw, yw)


# ---------------------------------------------------------------------------
# level-domain matmuls (unsigned, levels in 0..9)
# ---------------------------------------------------------------------------

def bp_matmul_lut(x_levels: torch.Tensor, y_levels: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """C[m, n] = sum_k LUT[x[m, k], y[k, n]] / 10, through one-hots."""
    lut = _table("lut", dtype, x_levels.device)
    xoh = F.one_hot(x_levels.long(), bp.NUM_LEVELS).to(dtype)
    yoh = F.one_hot(y_levels.long(), bp.NUM_LEVELS).to(dtype)
    return torch.einsum("mka,knb,ab->mn", xoh, yoh, lut) * 0.1


@device_constant
def _thresholds(which: str, dtype, device) -> torch.Tensor:
    """(8,) plane thresholds of one dataset: plane p is set iff level >=
    t[p] (the datasets are nested, ``bp.plane_thresholds``)."""
    return torch.tensor(bp.plane_thresholds(which), dtype=dtype,
                        device=device)


def encode_bitplanes(levels: torch.Tensor, which: str,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(...) integer levels -> (..., 8) 0/1 bitplanes of one dataset, as
    one elementwise comparison with the plane thresholds (the same planes
    as the dataset's table, without a gather)."""
    t = _thresholds("right" if which == "right" else "left", levels.dtype,
                    levels.device)
    return (levels[..., None] >= t).to(dtype)


def bp_matmul_bitplane(x_levels: torch.Tensor, y_levels: torch.Tensor,
                       dtype=torch.bfloat16,
                       out_dtype=torch.float32) -> torch.Tensor:
    """C = sum_p X_p @ Y_p / 10, folded into one matmul of 8x inner width
    (0/1 planes: exact in ``dtype``; summed in ``out_dtype``)."""
    if x_levels.shape[1] != y_levels.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(x_levels.shape)} @ "
                         f"{tuple(y_levels.shape)}")
    return _fold(encode_bitplanes(x_levels, "right", dtype),
                 encode_bitplanes(y_levels, "left", dtype), out_dtype) * 0.1


def bp_matmul_lowrank(x_levels: torch.Tensor, y_levels: torch.Tensor,
                      dtype=torch.float32, out_dtype=torch.float32,
                      rank: Optional[int] = None) -> torch.Tensor:
    """C = (L[x]) @ (R[y])^T / 10 with an r = rank(LUT) inner blow-up."""
    dev = x_levels.device
    return _fold(_table("low_left", dtype, dev, rank)[x_levels.long()],
                 _table("low_right", dtype, dev, rank)[y_levels.long()],
                 out_dtype) * 0.1


# ---------------------------------------------------------------------------
# signed, scaled real-tensor entry points
# ---------------------------------------------------------------------------

def bp_matmul(x: torch.Tensor, y: torch.Tensor, *, impl: str = "bitplane",
              accum_dtype=torch.float32) -> torch.Tensor:
    """OISMA-simulated ``x @ y`` of real 2-D matrices: both quantised to
    signed BP8 (per-tensor scale), multiplied bit-exactly, rescaled as
    ``c * ((sx * sy) * 0.1)``.  ``impl``: "lut", "bitplane" or "lowrank"."""
    if impl not in ("lut", "bitplane", "lowrank"):
        raise ValueError(f"unknown impl {impl!r}")
    qx, qy = quantize_bp(x), quantize_bp(y)
    sx = qx.sign.to(accum_dtype)[..., None]
    sy = qy.sign.to(accum_dtype)[..., None]
    dev = x.device
    if impl == "lut":
        lut = _table("lut", accum_dtype, dev)
        xoh = F.one_hot(qx.levels.long(), bp.NUM_LEVELS).to(accum_dtype) * sx
        yoh = F.one_hot(qy.levels.long(), bp.NUM_LEVELS).to(accum_dtype) * sy
        c = torch.einsum("mka,knb,ab->mn", xoh, yoh, lut)
    elif impl == "bitplane":
        c = _fold(encode_bitplanes(qx.levels, "right", accum_dtype) * sx,
                  encode_bitplanes(qy.levels, "left", accum_dtype) * sy,
                  accum_dtype)
    else:
        c = _fold(_table("low_left", accum_dtype, dev)[qx.levels.long()]
                  * sx,
                  _table("low_right", accum_dtype, dev)[qy.levels.long()]
                  * sy, accum_dtype)
    return c * ((qx.scale * qy.scale) * 0.1)


class _BPMatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, impl):
        ctx.save_for_backward(x, y)
        return bp_matmul(x, y, impl=impl)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (g @ y.T).to(x.dtype), (x.T @ g).to(y.dtype), None


def bp_matmul_ste(x: torch.Tensor, y: torch.Tensor, *,
                  impl: str = "bitplane") -> torch.Tensor:
    """``bp_matmul`` forward; the plain matmul's gradients (straight
    through), for OISMA-aware training."""
    return _BPMatmulSTE.apply(x, y, impl)
