"""Quantisation formats, expression for expression as the reference
computes them:

* Bent-Pyramid (BP8): sign-magnitude with a max-|x| scale, ten levels
  0.0 .. 0.9 (``quantize_bp``, ``quantize_bp_levels``, ``bp_dequantize``);
* FP8 E4M3, the paper's baseline: round |x| to the nearest representable
  magnitude (``quantize_e4m3``).

``fake_quantize_bp`` and ``fake_quantize_e4m3`` quantise and dequantise
with straight-through (identity) gradients.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.bp import NUM_LEVELS
from repro_torch.device import device_constant

Axis = Optional[Union[int, Sequence[int]]]


# ---------------------------------------------------------------------------
# FP8 (E4M3)
# ---------------------------------------------------------------------------

@functools.lru_cache(None)
def e4m3_positive_values(max_val: float = 448.0) -> np.ndarray:
    """All positive finite E4M3 values <= max_val (ascending)."""
    vals = set()
    for e in range(16):
        for m in range(8):
            if e == 15 and m == 7:
                continue  # NaN encoding
            v = (m / 8.0) * 2.0 ** (-6) if e == 0 else \
                (1 + m / 8.0) * 2.0 ** (e - 7)
            if 0.0 < v <= max_val:
                vals.add(v)
    return np.array(sorted(vals))


@functools.lru_cache(None)
def _e4m3_grid_and_mids(max_val: float) -> Tuple[np.ndarray, np.ndarray]:
    grid = np.concatenate([[0.0], e4m3_positive_values(max_val)])
    return grid, (grid[1:] + grid[:-1]) / 2.0


@device_constant
def _e4m3_tables(max_val: float, dtype, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The E4M3 grid and its midpoints on ``device``, made once."""
    grid, mids = _e4m3_grid_and_mids(max_val)
    return (torch.as_tensor(grid, dtype=dtype, device=device),
            torch.as_tensor(mids, dtype=dtype, device=device))


def quantize_e4m3(x: torch.Tensor, max_val: float = 448.0) -> torch.Tensor:
    """Round |x| to the nearest E4M3 magnitude (sign kept, ties to the
    smaller); magnitudes above ``max_val`` clip to it."""
    grid, _ = _e4m3_grid_and_mids(max_val)
    g, m = _e4m3_tables(max_val, x.dtype, x.device)
    idx = torch.searchsorted(m, torch.clamp_max(x.abs(), float(grid[-1])))
    return torch.sign(x) * g[idx]


# ---------------------------------------------------------------------------
# Bent-Pyramid
# ---------------------------------------------------------------------------

def quantize_bp_levels(x01: torch.Tensor) -> torch.Tensor:
    """Values in [0, 1] -> the nearest BP level, int32 in 0..9."""
    return torch.clamp(torch.round(x01 * 10.0), 0,
                       NUM_LEVELS - 1).to(torch.int32)


def bp_dequantize(levels: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return levels.to(dtype) / 10.0


@dataclasses.dataclass
class BPQuantized:
    """value ~= sign * (level / 10) * scale, scale broadcast along the
    reduced axes."""
    levels: torch.Tensor   # int8, 0..9
    sign: torch.Tensor     # int8, -1/0/1
    scale: torch.Tensor    # x.dtype, keepdim shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return ((self.sign.to(dtype) * self.levels.to(dtype) / 10.0)
                * self.scale.to(dtype))


def quantize_bp(x: torch.Tensor, axis: Axis = None) -> BPQuantized:
    """``scale = max(max|x|, tiny)``, ``level = clip(round(|x|/scale*10),
    0, 9)`` with round-half-to-even; ``axis`` = axes reduced for the scale
    (None = per-tensor)."""
    mag = x.abs()
    if axis is None:
        scale = mag.amax().reshape((1,) * x.dim())
    else:
        scale = mag.amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(scale, torch.finfo(x.dtype).tiny)
    levels = torch.clamp(torch.round(mag / scale * 10.0), 0, NUM_LEVELS - 1)
    return BPQuantized(levels.to(torch.int8), torch.sign(x).to(torch.int8),
                       scale)


class _FakeQuantizeBP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return quantize_bp(x, axis=axis).dequantize(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FakeQuantizeE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, max_val):
        return quantize_e4m3(x, max_val)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quantize_bp(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Quantise-dequantise through BP; the gradient passes straight
    through."""
    return _FakeQuantizeBP.apply(x, axis)


def fake_quantize_e4m3(x: torch.Tensor, max_val: float = 448.0) -> torch.Tensor:
    """Quantise-dequantise through FP8 E4M3; the gradient passes straight
    through."""
    return _FakeQuantizeE4M3.apply(x, max_val)
