"""Dataflow schedules for one OISMA array: loop-order cycle/toggle counts.

The array is always *weight-stationary* (operand B lives in the RRAM
cells); what a schedule chooses is how the input operand stream visits the
resident weight tile.  Following the npu_model style of loop-order
accounting, each schedule is reduced to two counts per (m × k_rows ×
n_words) tile:

  mult_cycles  — wordline-activation cycles to drain the tile
  input_loads  — input-register load (toggle) events

``input_loads`` is what separates the paper's two operating modes
(Table II):

* ``input_stationary`` (the paper's VMM mode): each input element x[m, k]
  is loaded once and broadcast across the whole active wordline, so all
  ``n_words`` column MACs of that cycle share one load —
  loads/MAC = 1/n_words.
* ``output_stationary`` (the paper's single-multiplication mode): the
  output accumulator is held while operands stream one multiplication per
  cycle; every MAC pays a full input-register load — loads/MAC = 1.

``repro_torch.sim.array`` splits Table II's multiply energy into a static AND +
popcount component and a per-load toggle component calibrated from exactly
these two endpoints, so the 17.6 % VMM saving (216 → 178 fJ/bit) is a
*derived* consequence of the loads/MAC ratio — and partially-filled edge
tiles (n_words < 32) land in between, which a hard-coded mode bit cannot
express.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """Loop-order schedule over one resident (k_rows × n_words) tile."""
    name: str
    #: documentation of the loop nest, outermost first; "n|cycle" means the
    #: n_words outputs of a wordline are produced in the same cycle.
    loop_order: Tuple[str, ...]
    mult_cycles: Callable[[float, int, int], float]
    input_loads: Callable[[float, int, int], float]

    def macs(self, m: float, k_rows: int, n_words: int) -> float:
        return m * k_rows * n_words

    def loads_per_mac(self, m: float, k_rows: int, n_words: int) -> float:
        return self.input_loads(m, k_rows, n_words) / self.macs(
            m, k_rows, n_words)


#: VMM mode: for each (m, k) the wordline k fires once with x[m, k]
#: broadcast; all n_words column MACs complete in that cycle.
INPUT_STATIONARY = Dataflow(
    name="input_stationary",
    loop_order=("m", "k", "n|cycle"),
    mult_cycles=lambda m, k, nw: m * k,
    input_loads=lambda m, k, nw: m * k,
)

#: single-multiplication mode: one MAC per cycle, operand registers
#: reloaded every cycle (the paper's scalar/elementwise operating point).
OUTPUT_STATIONARY = Dataflow(
    name="output_stationary",
    loop_order=("m", "n", "k"),
    mult_cycles=lambda m, k, nw: m * k * nw,
    input_loads=lambda m, k, nw: m * k * nw,
)

DATAFLOWS: Dict[str, Dataflow] = {
    "input_stationary": INPUT_STATIONARY,
    "vmm": INPUT_STATIONARY,
    "output_stationary": OUTPUT_STATIONARY,
    "single": OUTPUT_STATIONARY,
}


def get_dataflow(name: str) -> Dataflow:
    try:
        return DATAFLOWS[name]
    except KeyError:
        raise ValueError(f"unknown dataflow {name!r}; "
                         f"valid: {sorted(DATAFLOWS)}") from None


def vmm_saving_fraction(n_words: int = None) -> float:
    """Derived multiply-energy saving of VMM vs single-mult mode.

    With the calibrated static/toggle split this reproduces the paper's
    17.6 % (Table II) at the full row width, and less for narrower tiles.
    """
    from repro_torch.sim import array as arr
    nw = arr.WORDS_PER_ROW if n_words is None else n_words
    e_single = arr.E_MULT_STATIC_FJ_PER_BIT + arr.E_INPUT_LOAD_FJ_PER_BIT
    e_vmm = arr.E_MULT_STATIC_FJ_PER_BIT + arr.E_INPUT_LOAD_FJ_PER_BIT / nw
    return 1.0 - e_vmm / e_single
