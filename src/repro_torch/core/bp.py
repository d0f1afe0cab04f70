"""Bent-Pyramid (BP) datasets: the fixed bitstreams behind OISMA's multiply,
and the paper's stochastic reference of the in-array multiply.

The BP system represents the ten probabilities 0.0 .. 0.9 as fixed
10-bit words.  Multiplicands (activations) use the right-biased dataset,
multipliers (weights) the left-biased one; a product is the popcount of
the AND of the two words, over 10.  Both datasets are nested pyramids:
the block of ones for level n+1 contains the block for level n.  The
outer two bit positions never meet a one on the other side, so the
compressed BP8 form keeps bits 1..8 only.

The canonical datasets (``bent_pyramid_datasets``) are built from the
block start positions below, chosen by the design-time search
(``optimize_datasets``) against the paper's published accuracy.  What the
kernels need follows from them:

* ``plane_thresholds(which)`` — bit p of a level-l word is set iff
  ``l >= threshold[p]`` (nestedness), so the encode is 8 comparisons;
* ``level_masks(which)`` — the BP8 word of each level as an 8-bit mask,
  bit p = plane p, so one product is ``popcount(mask_r & mask_l)``;
* ``mult_lut()`` — the 10x10 table of those products.

The stochastic reference (``quantize_to_levels`` .. ``bp_matmul_bitplane``)
works on torch tensors on their own device, in float64 as the
reference's numpy does: quantise to levels, AND and popcount (the array),
accumulate (the periphery), scale by 1/10.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

BITS = 10           # logical BP10 width
EFFECTIVE_BITS = 8  # compressed BP8 width
NUM_LEVELS = 10     # probabilities 0.0 .. 0.9

#: Block start position of the run of ones for levels 0..9 of the canonical
#: datasets (level 0 is the empty word; its start is unused).
RIGHT_STARTS = (0, 6, 5, 5, 4, 4, 4, 3, 2, 1)
LEFT_STARTS = (0, 3, 3, 3, 2, 1, 1, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class BPDataset:
    """One of the two complementary BP datasets.

    ``starts[n]``/``lengths[n]`` give the contiguous block of ones for the
    level with ``n`` ones (probability ``n/10``) within the 10-bit word,
    positions indexed 0 (left-most) .. 9 (right-most).  Level 0 is the
    all-zero word.
    """

    name: str
    starts: Tuple[int, ...]   # length-10; starts[0] unused (level 0 empty)
    lengths: Tuple[int, ...]  # lengths[n] == n

    def __post_init__(self):
        if len(self.starts) != NUM_LEVELS or len(self.lengths) != NUM_LEVELS:
            raise ValueError(f"{self.name}: {NUM_LEVELS} starts and lengths")
        for n in range(NUM_LEVELS):
            if self.lengths[n] != n:
                raise ValueError(f"{self.name}: lengths[{n}] != {n}")
            if n and not 0 <= self.starts[n] <= BITS - n:
                raise ValueError(f"{self.name}: level {n} starts at "
                                 f"{self.starts[n]}")

    @functools.cached_property
    def bitstreams(self) -> np.ndarray:
        """(10, 10) uint8 array of the BP10 bitstreams, one row per level."""
        out = np.zeros((NUM_LEVELS, BITS), dtype=np.uint8)
        for n in range(1, NUM_LEVELS):
            s = self.starts[n]
            out[n, s : s + n] = 1
        return out

    @functools.cached_property
    def bitstreams_bp8(self) -> np.ndarray:
        """(10, 8) uint8 array — BP8 compressed view (drop bit0 and bit9)."""
        return self.bitstreams[:, 1 : BITS - 1].copy()

    def words(self, bits: int = BITS) -> np.ndarray:
        """Integer codewords (MSB = left-most bit)."""
        bs = self.bitstreams if bits == BITS else self.bitstreams_bp8
        weights = 1 << np.arange(bits - 1, -1, -1, dtype=np.int64)
        return (bs.astype(np.int64) * weights).sum(axis=1)


def _blocks_to_dataset(name: str, starts: Sequence[int]) -> BPDataset:
    return BPDataset(name=name, starts=tuple(starts),
                     lengths=tuple(range(NUM_LEVELS)))


def bent_pyramid_datasets() -> Tuple[BPDataset, BPDataset]:
    """The canonical (right-biased, left-biased) datasets.

    Both are nested pyramids that reproduce the two entries the paper
    prints (right-biased 0.3 = 0000011100, left-biased 0.6 = 0111111000)
    and its structural constraints (right-biased bit 0 and left-biased
    bit 9 always zero); of all such pairs, this one reproduces the
    paper's accuracy curve (Fig. 7: 9.41% at 4x4 against the paper's
    9.42%, 1.67% at 512x512 against 1.81%).
    """
    return (_blocks_to_dataset("right-biased", RIGHT_STARTS),
            _blocks_to_dataset("left-biased", LEFT_STARTS))


@functools.lru_cache(None)
def _canonical(which: str) -> BPDataset:
    if which not in ("right", "left"):
        raise ValueError(f"dataset must be 'right' or 'left', not {which!r}")
    return bent_pyramid_datasets()[which == "left"]


def bitstreams(which: str) -> np.ndarray:
    """(10, 10) uint8 BP10 bitstreams of one canonical dataset."""
    return _canonical(which).bitstreams


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


def mult_lut(right: BPDataset | None = None,
             left: BPDataset | None = None) -> np.ndarray:
    """(10, 10) int32 table: popcount(AND(right[a], left[b])) over BP10
    words, of the canonical datasets unless both are given."""
    if right is None or left is None:
        right, left = _canonical("right"), _canonical("left")
    r = right.bitstreams.astype(np.int32)
    l = left.bitstreams.astype(np.int32)
    return r @ l.T  # popcount of AND == dot product of 0/1 vectors


def optimize_datasets(
    pins_right: dict[int, int] | None = None,
    pins_left: dict[int, int] | None = None,
    weight: np.ndarray | None = None,
    iters: int = 50,
    seed_datasets: Tuple[BPDataset, BPDataset] | None = None,
) -> Tuple[BPDataset, BPDataset]:
    """Design-time alternating search over block placements.

    Minimises sum_ab w[a,b] * (overlap(a,b) - a*b/10)^2 subject to the
    structural constraints.  Because the objective is separable per level
    once the opposite dataset is fixed, each sweep is exact; alternating
    sweeps converge to a local optimum in a handful of iterations.

    ``pins_right`` / ``pins_left`` pin {level: start} placements (e.g. the
    two examples published in the paper).
    """
    pins_right = dict(pins_right or {})
    pins_left = dict(pins_left or {})
    if weight is None:
        weight = np.ones((NUM_LEVELS, NUM_LEVELS))

    if seed_datasets is None:
        seed_datasets = bent_pyramid_datasets()
    r_starts = list(seed_datasets[0].starts)
    l_starts = list(seed_datasets[1].starts)

    def overlap(rs: int, n_a: int, ls: int, n_b: int) -> int:
        if n_a == 0 or n_b == 0:
            return 0
        lo = max(rs, ls)
        hi = min(rs + n_a, ls + n_b)
        return max(0, hi - lo)

    def err_for(rs: int, n_a: int, ls_all: Sequence[int]) -> float:
        e = 0.0
        for b in range(NUM_LEVELS):
            ov = overlap(rs, n_a, ls_all[b], b)
            e += weight[n_a, b] * (ov - n_a * b / 10.0) ** 2
        return e

    for _ in range(iters):
        changed = False
        # sweep right placements (right-biased: block within bits 1..9)
        for a in range(1, NUM_LEVELS):
            if a in pins_right:
                r_starts[a] = pins_right[a]
                continue
            best, best_e = r_starts[a], err_for(r_starts[a], a, l_starts)
            for cand in range(1, BITS - a + 1):
                e = err_for(cand, a, l_starts)
                if e < best_e - 1e-12:
                    best, best_e = cand, e
            if best != r_starts[a]:
                r_starts[a] = best
                changed = True
        # sweep left placements (left-biased: block within bits 0..8)
        for b in range(1, NUM_LEVELS):
            if b in pins_left:
                l_starts[b] = pins_left[b]
                continue

            def err_for_l(ls: int) -> float:
                e = 0.0
                for a in range(NUM_LEVELS):
                    ov = overlap(r_starts[a], a, ls, b)
                    e += weight[a, b] * (ov - a * b / 10.0) ** 2
                return e

            best, best_e = l_starts[b], err_for_l(l_starts[b])
            for cand in range(0, BITS - 1 - b + 1):
                e = err_for_l(cand)
                if e < best_e - 1e-12:
                    best, best_e = cand, e
            if best != l_starts[b]:
                l_starts[b] = best
                changed = True
        if not changed:
            break

    return (
        _blocks_to_dataset("right-biased(opt)", r_starts),
        _blocks_to_dataset("left-biased(opt)", l_starts),
    )


# ---------------------------------------------------------------------------
# The stochastic reference on torch tensors (the reference's numpy forms):
# each computes on its input's device.
# ---------------------------------------------------------------------------

def quantize_to_levels(x) -> torch.Tensor:
    """Map values in [0, 1] to the nearest BP level (int32 in 0..9).

    Ties round half to even; values above 0.95 clip to level 9 (the
    paper's data-mapping phase, Fig. 5).  A floating input is scaled in
    its own type, as numpy keeps a float32 array times 10.0 in float32;
    an integer input is scaled in float64, as numpy promotes it.
    """
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    return torch.clamp(torch.round(x * 10.0), 0, NUM_LEVELS - 1).to(
        torch.int32)


def levels_to_prob(levels) -> torch.Tensor:
    return torch.as_tensor(levels).to(torch.float64) / 10.0


def encode(levels, dataset: BPDataset, bits: int = BITS) -> torch.Tensor:
    """Expand an integer-level tensor (...) to uint8 bitstreams (..., bits)."""
    levels = torch.as_tensor(levels)
    table = dataset.bitstreams if bits == BITS else dataset.bitstreams_bp8
    return torch.as_tensor(table, device=levels.device)[levels.long()]


def sc_multiply(x_levels, y_levels, right: BPDataset | None = None,
                left: BPDataset | None = None,
                bits: int = BITS) -> torch.Tensor:
    """Bit-faithful stochastic multiply: popcount(AND(right[x], left[y])),
    int32, over the broadcast shape of the two level tensors."""
    if right is None or left is None:
        right, left = _canonical("right"), _canonical("left")
    xb = encode(x_levels, right, bits)
    yb = encode(y_levels, left, bits)
    return torch.bitwise_and(xb, yb).sum(dim=-1).to(torch.int32)


def bp_matmul_reference(x, y, right: BPDataset | None = None,
                        left: BPDataset | None = None) -> torch.Tensor:
    """Full OISMA MatMul reference on real-valued inputs in [0, 1], in
    float64: quantize -> stochastic multiply (AND + popcount, the
    in-array op, as the table ``mult_lut``) -> binary accumulate (the
    periphery) -> scale by 1/10.  Output approximates ``x @ y``.

    x's one-hot levels (M, K*10) times the table's rows at y's levels
    (K*10, N): one matmul.  Every sum is an integer below 2^53, so the
    result is bitwise the reference's three-operand einsum.
    """
    xl = quantize_to_levels(x)
    yl = quantize_to_levels(y)
    (m, k), n = xl.shape, yl.shape[1]
    lut = torch.as_tensor(mult_lut(right, left), device=xl.device).to(
        torch.float64)
    xoh = torch.eye(NUM_LEVELS, dtype=torch.float64, device=xl.device)[
        xl.long()].reshape(m, k * NUM_LEVELS)
    rows = lut[:, yl.long()].permute(1, 0, 2).reshape(k * NUM_LEVELS, n)
    return (xoh @ rows) / 10.0


def bp_matmul_bitplane(x, y, right: BPDataset | None = None,
                       left: BPDataset | None = None,
                       bits: int = BITS) -> torch.Tensor:
    """Bitplane formulation: sum_p X_p @ Y_p, identical to the AND/popcount
    reference (popcount(AND) == dot of 0/1 bitplanes), as one float64
    matmul over K*bits."""
    if right is None or left is None:
        right, left = _canonical("right"), _canonical("left")
    xl = quantize_to_levels(x)
    yl = quantize_to_levels(y)
    (m, k), n = xl.shape, yl.shape[1]
    xb = encode(xl, right, bits).to(torch.float64).reshape(m, k * bits)
    yb = encode(yl, left, bits).to(torch.float64).permute(0, 2, 1).reshape(
        k * bits, n)
    return (xb @ yb) / 10.0
