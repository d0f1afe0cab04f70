"""Bent-Pyramid quantisation of a real tensor (sign-magnitude, max-|x|
scale), expression for expression as the reference computes it."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.core.bp import NUM_LEVELS


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


def quantize_bp(x: torch.Tensor,
                axis: Optional[Union[int, Sequence[int]]] = None
                ) -> BPQuantized:
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
