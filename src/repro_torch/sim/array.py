"""Tile-level timing/energy model of one 4 kB OISMA array.

Geometry (Sec. IV): 256 bit columns × 128 wordlines of 1T1R RRAM — two
128×128 effective subarrays — holding 128 rows × 32 BP8 words.  Each
compute cycle activates one wordline against the input register and
accumulates up to 32 BP8 MACs in the popcount/adder-tree periphery.

Energy accounting refines ``repro_torch.core.oisma_cost``'s closed-form MAC
energy into per-event components so a mapper can price real (imperfect)
tilings:

* multiply: Table II's two operating points (216 fJ/bit single-mult,
  178 fJ/bit VMM) are decomposed into a static AND+popcount term plus an
  input-register load (toggle) term, calibrated so that one load per MAC
  reproduces 216 and one load per 32-MAC wordline reproduces 178 exactly.
  The loads/MAC ratio comes from the dataflow (repro_torch.sim.dataflow), so the
  VMM saving — and its partial loss on narrow edge tiles — is derived, not
  hard-coded.
* accumulate: 102.65 fJ/bit (Table II), charged per MAC.
* read: 237 fJ/bit (Table II) — a *plain* memory read.  In OISMA the
  weight read IS the multiplication, so matmuls never pay this; it is
  exposed for non-compute accesses (weight readback/verify).
* reprogram: RRAM writes when a weight tile is (re)programmed.  The paper
  does not publish write costs; the assumptions (10 pJ/bit, 1 µs/row)
  live in ONE place — ``repro_torch.sim.calibration.RRAMWriteCalibration`` —
  and thread EngineConfig -> ArrayModel -> ``program_tile``, so a future
  calibration against published data is a single override.  Write energy
  is device-limited and does NOT scale with the CMOS node; write *time*
  is fixed in seconds (stall cycles grow with clock frequency).

Technology scaling mirrors oisma_cost's DeepScaleTool endpoint factors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core import oisma_cost as oc
from repro_torch.sim.calibration import DEFAULT_WRITE_CAL, RRAMWriteCalibration

BITS_PER_WORD = 8                       # compressed BP8
ROWS_PER_ARRAY = oc.ARRAY_ROWS          # 128 wordlines
WORDS_PER_ROW = oc.BP8_WORDS_PER_ROW    # 32 BP8 words per wordline
MACS_PER_CYCLE = oc.MACS_PER_CYCLE_PER_ARRAY
WORDS_PER_ARRAY = ROWS_PER_ARRAY * WORDS_PER_ROW

# --- multiply-energy decomposition (calibrated from Table II) --------------
#: per-load input-register toggle energy: solves
#:   static + load          = E_MULT_SINGLE   (1 load per MAC)
#:   static + load / 32     = E_MULT_VMM      (1 load per full wordline)
E_INPUT_LOAD_FJ_PER_BIT = (
    (oc.E_MULT_SINGLE_FJ_PER_BIT - oc.E_MULT_VMM_FJ_PER_BIT)
    / (1.0 - 1.0 / WORDS_PER_ROW))
E_MULT_STATIC_FJ_PER_BIT = oc.E_MULT_SINGLE_FJ_PER_BIT - E_INPUT_LOAD_FJ_PER_BIT

# --- RRAM programming assumptions (single source: sim/calibration.py) ------
#: legacy aliases of the default calibration's numbers; new code should
#: read them off an ArrayModel/EngineConfig ``write_cal`` instead
RRAM_WRITE_FJ_PER_BIT = DEFAULT_WRITE_CAL.write_fj_per_bit
RRAM_WRITE_S_PER_ROW = DEFAULT_WRITE_CAL.write_s_per_row

# --- macro power: array + accumulation periphery ---------------------------
#: The abstract's 0.789 TOPS/W is the whole-macro endpoint; Table III's
#: 0.891 TOPS/W (= 3.2 GOPS / 3.59 mW) is the array alone.  The implied
#: accumulation-periphery power is the difference (~0.47 mW/array).
POWER_MACRO_4KB_180NM_W = oc.PEAK_GOPS_4KB_180NM / 1e3 / 0.789
POWER_PERIPHERY_180NM_W = POWER_MACRO_4KB_180NM_W - oc.POWER_180NM_W


@dataclasses.dataclass(frozen=True)
class TileCost:
    """Cost of one unit of work on one array (joules / cycles / MACs)."""
    cycles: float
    macs: float
    e_read_j: float = 0.0      # input-operand delivery (toggle component)
    e_mult_j: float = 0.0      # static AND + popcount component
    e_accum_j: float = 0.0     # adder-tree accumulation
    e_reprogram_j: float = 0.0

    @property
    def energy_j(self) -> float:
        return self.e_read_j + self.e_mult_j + self.e_accum_j + \
            self.e_reprogram_j

    def __add__(self, o: "TileCost") -> "TileCost":
        return TileCost(self.cycles + o.cycles, self.macs + o.macs,
                        self.e_read_j + o.e_read_j,
                        self.e_mult_j + o.e_mult_j,
                        self.e_accum_j + o.e_accum_j,
                        self.e_reprogram_j + o.e_reprogram_j)

    def scaled(self, f: float) -> "TileCost":
        return TileCost(self.cycles * f, self.macs * f, self.e_read_j * f,
                        self.e_mult_j * f, self.e_accum_j * f,
                        self.e_reprogram_j * f)


@dataclasses.dataclass(frozen=True)
class ArrayModel:
    """One 4 kB OISMA array at a technology node."""
    technology_nm: int = 180
    write_cal: RRAMWriteCalibration = DEFAULT_WRITE_CAL

    @property
    def rram_write_fj_per_bit(self) -> float:
        return self.write_cal.write_fj_per_bit

    @property
    def rram_write_s_per_row(self) -> float:
        return self.write_cal.write_s_per_row

    @property
    def _oc(self) -> oc.OISMAConfig:
        return oc.OISMAConfig(technology_nm=self.technology_nm, arrays=1)

    @property
    def freq_hz(self) -> float:
        return self._oc.freq_hz

    @property
    def energy_scale(self) -> float:
        """Dynamic-energy improvement vs 180 nm — exactly the closed-form
        model's MAC-energy scaling (power × freq), so the two models can
        never diverge per node."""
        return oc.E_MAC_PJ / self._oc.mac_energy_pj

    def compute_tile(self, macs: float, input_loads: float,
                     cycles: float) -> TileCost:
        """Energy/latency of ``macs`` BP8 MACs given the schedule counts."""
        s = 1e-15 * BITS_PER_WORD / self.energy_scale
        return TileCost(
            cycles=cycles, macs=macs,
            e_read_j=input_loads * E_INPUT_LOAD_FJ_PER_BIT * s,
            e_mult_j=macs * E_MULT_STATIC_FJ_PER_BIT * s,
            e_accum_j=macs * oc.E_ACCUM_FJ_PER_BIT * s)

    def program_tile(self, k_rows: int, n_words: int) -> TileCost:
        """(Re)program a (k_rows × n_words) weight tile into the RRAM."""
        bits = k_rows * n_words * BITS_PER_WORD
        return TileCost(
            cycles=k_rows * self.rram_write_s_per_row * self.freq_hz,
            macs=0.0,
            e_reprogram_j=bits * self.rram_write_fj_per_bit * 1e-15)

    def plain_read_energy_j(self, words: float) -> float:
        """Non-compute RRAM read (readback/verify) — Table II's 237 fJ/bit."""
        return words * BITS_PER_WORD * oc.E_READ_FJ_PER_BIT * 1e-15 \
            / self.energy_scale
