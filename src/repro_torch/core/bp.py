"""Bent-Pyramid (BP) datasets: the fixed bitstreams behind OISMA's multiply.

The BP system represents the ten probabilities 0.0 .. 0.9 as fixed
10-bit words.  Multiplicands (activations) use the right-biased dataset,
multipliers (weights) the left-biased one; a product is the popcount of
the AND of the two words, over 10.  Both datasets are nested pyramids:
the block of ones for level n+1 contains the block for level n.  The
outer two bit positions never meet a one on the other side, so the
compressed BP8 form keeps bits 1..8 only.

Everything the kernels need follows from the block start positions
below (the reference's canonical datasets, chosen there by a search
against the paper's published accuracy):

* ``plane_thresholds(which)`` — bit p of a level-l word is set iff
  ``l >= threshold[p]`` (nestedness), so the encode is 8 comparisons;
* ``level_masks(which)`` — the BP8 word of each level as an 8-bit mask,
  bit p = plane p, so one product is ``popcount(mask_r & mask_l)``;
* ``mult_lut()`` — the 10x10 table of those products.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

BITS = 10           # logical BP10 width
EFFECTIVE_BITS = 8  # compressed BP8 width
NUM_LEVELS = 10     # probabilities 0.0 .. 0.9

#: Block start position of the run of ones for levels 0..9 (level 0 is
#: the empty word; its start is unused).
RIGHT_STARTS = (0, 6, 5, 5, 4, 4, 4, 3, 2, 1)
LEFT_STARTS = (0, 3, 3, 3, 2, 1, 1, 0, 0, 0)


def _starts(which: str) -> Tuple[int, ...]:
    if which == "right":
        return RIGHT_STARTS
    if which == "left":
        return LEFT_STARTS
    raise ValueError(f"dataset must be 'right' or 'left', not {which!r}")


@functools.lru_cache(None)
def bitstreams(which: str) -> np.ndarray:
    """(10, 10) uint8 BP10 bitstreams of one dataset, one row per level."""
    out = np.zeros((NUM_LEVELS, BITS), np.uint8)
    for n, s in enumerate(_starts(which)):
        if n:
            out[n, s:s + n] = 1
    return out


def bitstreams_bp8(which: str) -> np.ndarray:
    """(10, 8) uint8 BP8 view: bit positions 1..8 of the BP10 words."""
    return bitstreams(which)[:, 1:BITS - 1].copy()


@functools.lru_cache(None)
def plane_thresholds(which: str) -> Tuple[int, ...]:
    """Per-plane level thresholds: plane p is set iff level >= t[p]."""
    table = bitstreams_bp8(which)
    thresh = []
    for p in range(EFFECTIVE_BITS):
        levels_set = [lv for lv in range(NUM_LEVELS) if table[lv, p]]
        t = min(levels_set) if levels_set else NUM_LEVELS
        if levels_set != list(range(t, NUM_LEVELS)):
            raise AssertionError(f"{which} dataset is not nested at bit {p}")
        thresh.append(t)
    return tuple(thresh)


@functools.lru_cache(None)
def level_masks(which: str) -> Tuple[int, ...]:
    """BP8 word of each level 0..9 as an int, bit p = plane p."""
    t = plane_thresholds(which)
    return tuple(sum(1 << p for p in range(EFFECTIVE_BITS) if lv >= t[p])
                 for lv in range(NUM_LEVELS))


def packed_thresholds(which: str) -> int:
    """The 8 thresholds packed 4 bits each (plane p at bits 4p..4p+3),
    the form the CUDA kernels take them in."""
    return sum(t << (4 * p) for p, t in enumerate(plane_thresholds(which)))


def mult_lut() -> np.ndarray:
    """(10, 10) int32: popcount(AND(right[a], left[b])) over BP10 words."""
    r = bitstreams("right").astype(np.int32)
    l = bitstreams("left").astype(np.int32)
    return r @ l.T
