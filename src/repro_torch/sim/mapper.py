"""Workload mapper: compile (M, K, N) matmuls onto an OISMA engine.

Weight-stationary mapping.  The (K × N) operand is cut into tiles of up to
128 rows × 32 BP8 words (one array's worth of resident weights); tiles are
assigned to the engine's ``banks × arrays_per_bank`` arrays in rounds.
Within a round every array drains its tile against all M input rows in
parallel, so a round's wall-clock is the *largest* tile's cycle count;
when there are more tiles than arrays, later rounds must reprogram the
RRAM (write energy, and a stall whose exposure depends on the buffering
mode).  Matmuls tagged non-stationary (attention score/value
contractions: both operands are activations) reprogram on every tile —
the mapper makes that cost visible instead of pretending the engine only
ever sees friendly workloads.

Reprogramming comes in two wall-clock modes (energy is identical):

* serial (``double_buffered=False``, the default and the paper's single
  weight plane): round r's writes stall the engine for the full
  port-limited program time p_r before its compute c_r starts.
* double-buffered (``double_buffered=True``): while round r computes on
  the active plane, round r+1's tiles program the shadow plane, so only
  ``max(0, p_{r+1} − c_r)`` of each program is exposed; the round-walk
  recurrence is ``start_{r+1} = start_r + c_r + max(0, p_{r+1} − c_r)``.

Writes drain through ``write_ports_per_bank`` ports per bank (default:
one port per array, i.e. all arrays program in parallel); fewer ports
serialize a round's writes into waves and stretch p_r.  The full
cycle/energy accounting story is written down in docs/sim_scaleout.md.

INVARIANT: the closed-form tile-class accounting below — at most four
(k_rows × n_words) classes per matmul (interior + K-edge + N-edge +
corner), with the round walk iterating over rounds, not tiles, so mapping
a 10^12-MAC model is O(tiles / arrays) cheap arithmetic — must equal a
brute-force per-tile enumeration (cycles AND energy, both buffering
modes, any port count).  The reference's ``tests/test_sim.py`` pins
this invariant there (``_brute_force``/``_brute_force_timeline``
re-derive every quantity tile by tile), and ``tests/test_torch_sim.py``
holds this copy's reports equal to the reference's, field by field.

Achieved-vs-peak metrics come in two flavours:

* ``achieved_tops_per_watt`` — dynamic-energy based (2·MACs / energy);
  reproduces Table III's array-level 0.891 TOPS/W at the ideal point.
* ``macro_tops_per_watt`` — throughput / whole-macro power (array +
  accumulation periphery); reproduces the abstract's 0.789 TOPS/W.

Multi-engine scale-out (sharding one inventory over E engines with
accumulation traffic) lives in ``repro_torch.sim.scaleout``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import oisma_cost as oc
from repro_torch.sim import array as arr
from repro_torch.sim.array import ArrayModel, TileCost
from repro_torch.sim.calibration import DEFAULT_WRITE_CAL, RRAMWriteCalibration
from repro_torch.sim.dataflow import Dataflow, get_dataflow
from repro_torch.sim.trace import TileEvent, Trace


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """An OISMA engine: banks × arrays_per_bank 4 kB arrays at a node."""
    banks: int = oc.ENGINE_BANKS                 # 64
    arrays_per_bank: int = oc.ARRAYS_PER_BANK    # 4  (64 x 4 = 1 MB)
    technology_nm: int = 180
    dataflow: str = "vmm"
    #: validation knob: RRAM (re)programming is free (no stall, no energy)
    free_programming: bool = False
    #: charge the first residency of stationary weights into the totals
    #: (default: weights are preloaded; the cost is still reported)
    count_initial_programming: bool = False
    #: RRAM write-cost assumptions — the single override point for the
    #: whole engine (see repro_torch.sim.calibration)
    write_cal: RRAMWriteCalibration = DEFAULT_WRITE_CAL
    #: write ports per bank: how many of a bank's arrays can program
    #: concurrently.  0 (default) means one port per array — every write
    #: of a round proceeds in parallel, the legacy model; 1 serializes a
    #: bank's writes completely.
    write_ports_per_bank: int = 0
    #: shadow weight plane per array: round r+1's tiles program while
    #: round r computes, so only max(0, program − compute) of each
    #: reprogram is exposed wall-clock (energy unchanged).
    double_buffered: bool = False
    #: area overhead charged for the shadow plane when double-buffered.
    #: Default 0: the 1T1R cell plane is a small fraction of the
    #: periphery-dominated macro (the paper publishes no cell/periphery
    #: area split) — a documented assumption, overridable per engine.
    shadow_area_overhead: float = 0.0

    @property
    def arrays(self) -> int:
        return self.banks * self.arrays_per_bank

    @property
    def write_ports(self) -> int:
        """Effective concurrent writes per bank (clamped to the arrays)."""
        if self.write_ports_per_bank <= 0:
            return self.arrays_per_bank
        return min(self.write_ports_per_bank, self.arrays_per_bank)

    @property
    def array_model(self) -> ArrayModel:
        return ArrayModel(technology_nm=self.technology_nm,
                          write_cal=self.write_cal)

    @property
    def _oc(self) -> oc.OISMAConfig:
        """The closed-form model this engine must stay consistent with."""
        return oc.OISMAConfig(technology_nm=self.technology_nm,
                              arrays=self.arrays)

    @property
    def freq_hz(self) -> float:
        return self._oc.freq_hz

    @property
    def macs_per_cycle(self) -> int:
        return arr.WORDS_PER_ROW * self.arrays

    @property
    def peak_gops(self) -> float:
        return self._oc.peak_tops * 1e3

    @property
    def power_w(self) -> float:
        """Array power (Table III basis)."""
        return self._oc.power_w

    @property
    def macro_power_w(self) -> float:
        """Array + accumulation periphery (the abstract's basis).

        The periphery is static-power dominated, so it scales with the
        node like the array power does in the closed-form model."""
        return self._oc.power_w * (arr.POWER_MACRO_4KB_180NM_W
                                   / oc.POWER_180NM_W)

    @property
    def area_mm2(self) -> float:
        a = self._oc.area_mm2
        if self.double_buffered:
            a *= 1.0 + self.shadow_area_overhead
        return a


@dataclasses.dataclass(frozen=True)
class MatmulReport:
    """Mapping result for one matmul class (cycles are wall-clock)."""
    name: str
    m: float
    k: int
    n: int
    count: float
    stationary: bool
    tiles: float
    rounds: float
    compute_cycles: float
    reprogram_cycles: float       # stalls inside the totals
    cost: TileCost                # total energy over all ``count`` passes
    program_cost: TileCost        # initial residency (reported, see engine)
    freq_hz: float
    macs_per_cycle_peak: float

    @property
    def macs(self) -> float:
        return self.cost.macs

    @property
    def total_cycles(self) -> float:
        return self.compute_cycles + self.reprogram_cycles

    @property
    def latency_s(self) -> float:
        return self.total_cycles / self.freq_hz

    @property
    def utilization(self) -> float:
        denom = self.total_cycles * self.macs_per_cycle_peak
        return self.macs / denom if denom else 0.0

    @property
    def achieved_gops(self) -> float:
        return (oc.OPS_PER_MAC * self.macs / self.latency_s / 1e9
                if self.latency_s else 0.0)

    @property
    def energy_per_mac_pj(self) -> float:
        return self.cost.energy_j / self.macs * 1e12 if self.macs else 0.0

    @property
    def achieved_tops_per_watt(self) -> float:
        e = self.cost.energy_j
        return oc.OPS_PER_MAC * self.macs / e / 1e12 if e else 0.0


def _tile_classes(k: int, n: int) -> List[Tuple[int, int, int]]:
    """(k_rows, n_words, count) tile classes of a (K × N)-word operand."""
    tkf, kr = divmod(k, arr.ROWS_PER_ARRAY)
    tnf, nr = divmod(n, arr.WORDS_PER_ROW)
    out = []
    if tkf and tnf:
        out.append((arr.ROWS_PER_ARRAY, arr.WORDS_PER_ROW, tkf * tnf))
    if tkf and nr:
        out.append((arr.ROWS_PER_ARRAY, nr, tkf))
    if kr and tnf:
        out.append((kr, arr.WORDS_PER_ROW, tnf))
    if kr and nr:
        out.append((kr, nr, 1))
    return out


def _round_program_cycles(bounds, lo: int, hi: int, apb: int, ports: int,
                          am: ArrayModel) -> float:
    """Port-limited wall-clock program time of one round's writes.

    Within a round, tiles are written deepest-first and distributed to
    banks in blocks of ``apb``; each bank drains its block through
    ``ports`` write ports in waves (a wave's duration is its deepest
    tile's program time).  Bank 0 holds the deepest block and each of its
    waves dominates the corresponding wave of every other bank (per-row
    program time is monotone in tile depth), so the round's program time
    is bank 0's wave sum.  The brute-force enumeration in
    the reference's tests/test_sim.py takes the max over ALL banks and
    must agree.
    """
    kts = sorted(((kt, min(hi, h) - max(lo, l))
                  for l, h, kt, nw in bounds if l < hi and h > lo),
                 reverse=True)
    n_bank0 = min(apb, hi - lo)
    cycles = 0.0
    consumed = 0
    for kt, cnt in kts:
        if consumed >= n_bank0:
            break
        take = min(cnt, n_bank0 - consumed)
        # waves whose first (deepest) tile falls in this kt run: wave
        # starts are the multiples of ``ports`` in [consumed, consumed+take)
        first = -(-consumed // ports) * ports
        if first < consumed + take:
            n_waves = (consumed + take - 1 - first) // ports + 1
            cycles += n_waves * am.program_tile(kt, 1).cycles
        consumed += take
    return cycles


def map_matmul(m: float, k: int, n: int, engine: EngineConfig = None, *,
               name: str = "matmul", stationary: bool = True,
               count: float = 1.0,
               trace: Optional[Trace] = None) -> MatmulReport:
    """Map an (m × k) @ (k × n) BP8 matmul onto ``engine``.

    ``n`` is in BP8 numbers (= output words).  ``m``/``count`` may be
    fractional (per-expert token averages).  Returns wall-clock cycles,
    utilization, and the read/mult/accum/reprogram energy budget.
    """
    engine = engine or EngineConfig()
    am = engine.array_model
    df = get_dataflow(engine.dataflow)
    A = engine.arrays
    # deepest/widest first; cycle-cost ties broken by (kt, nw) so that the
    # per-class accounting matches a per-tile enumeration exactly
    classes = sorted(_tile_classes(k, n),
                     key=lambda c: (df.mult_cycles(m, c[0], c[1]),
                                    c[0], c[1]),
                     reverse=True)
    T = sum(c[2] for c in classes)
    if T == 0 or m <= 0:
        zero = TileCost(0.0, 0.0)
        return MatmulReport(name, m, k, n, count, stationary, 0, 0, 0.0,
                            0.0, zero, zero, am.freq_hz,
                            engine.macs_per_cycle)
    rounds = math.ceil(T / A)
    free = engine.free_programming

    # class boundaries in sorted tile order
    bounds = []
    cum = 0
    for kt, nw, cnt in classes:
        bounds.append((cum, cum + cnt, kt, nw))
        cum += cnt

    def _class_at(idx: int) -> Tuple[int, int]:
        for lo, hi, kt, nw in bounds:
            if lo <= idx < hi:
                return kt, nw
        return bounds[-1][2], bounds[-1][3]

    # wall-clock: per round, compute = largest tile; a round's writes take
    # the port-limited program time p_r.  Serial mode exposes p_r in full;
    # double-buffered mode programs round r+1's tiles into the shadow
    # plane while round r computes, exposing only max(0, p_r − c_{r−1}).
    compute_cycles = 0.0
    p0 = 0.0
    rest_serial = 0.0
    rest_exposed = 0.0
    prev_c = 0.0
    apb = engine.arrays_per_bank
    ports = engine.write_ports
    for r in range(rounds):
        lo, hi = r * A, min(T, (r + 1) * A)
        kt0, nw0 = _class_at(lo)
        c_r = df.mult_cycles(m, kt0, nw0)
        compute_cycles += c_r
        if not free:
            p_r = _round_program_cycles(bounds, lo, hi, apb, ports, am)
            if r == 0:
                p0 = p_r
            else:
                rest_serial += p_r
                rest_exposed += max(0.0, p_r - prev_c)
        prev_c = c_r
    c_last = prev_c

    # ``count`` instances are DISTINCT weight matrices (merged per-layer /
    # per-expert classes): the engine's A-array residency is shared across
    # the whole concatenated tile stream, so only the first
    # min(A, count*T) tiles are first-use programming — everything beyond
    # (later rounds AND later instances) is a steady-state rewrite.
    if stationary and not free:
        resident = min(float(A), count * T)
        free_passes = min(count, float(A // T)) if T <= A else 1.0
    else:
        resident = 0.0
        free_passes = 0.0
    full_inst = int(resident // T) if T else 0
    rem = resident - full_inst * T
    program_cycles = p0 * free_passes
    if engine.double_buffered and not free:
        # steady state: instance i+1's round-0 writes overlap instance i's
        # last-round compute; the very first written round of a
        # non-stationary stream has no prior compute to hide behind.
        exposed0 = max(0.0, p0 - c_last)
        reprogram_cycles = rest_exposed * count
        if stationary:
            reprogram_cycles += exposed0 * (count - free_passes)
        else:
            first = min(count, 1.0)
            reprogram_cycles += p0 * first + exposed0 * (count - first)
    else:
        reprogram_cycles = (rest_serial * count
                            + p0 * (count - free_passes))

    # energy: sum over all tiles by class
    compute = TileCost(0.0, 0.0)
    reprogram = TileCost(0.0, 0.0)
    program = TileCost(0.0, 0.0)
    events: List[TileEvent] = []
    for lo, hi, kt, nw in bounds:
        cnt = hi - lo
        one = am.compute_tile(df.macs(m, kt, nw),
                              df.input_loads(m, kt, nw),
                              df.mult_cycles(m, kt, nw))
        cls_compute = one.scaled(cnt * count)
        compute = compute + cls_compute
        if trace is not None:
            events.append(TileEvent(name, "compute", kt, nw, cnt * count,
                                    cls_compute))
        if free:
            continue
        w_one = am.program_tile(kt, nw)
        n_initial = full_inst * cnt + min(max(rem - lo, 0.0), float(cnt))
        n_rewrite = count * cnt - n_initial
        if n_rewrite:
            cls_w = w_one.scaled(n_rewrite)
            reprogram = reprogram + cls_w
            if trace is not None:
                events.append(TileEvent(name, "reprogram", kt, nw,
                                        n_rewrite, cls_w))
        if n_initial:
            cls_p = w_one.scaled(n_initial)
            program = program + cls_p
            if trace is not None:
                events.append(TileEvent(name, "program", kt, nw,
                                        n_initial, cls_p))

    total = compute + reprogram
    total_reprogram_cycles = reprogram_cycles
    if engine.count_initial_programming:
        total = total + program
        total_reprogram_cycles += program_cycles
    if trace is not None:
        trace.extend(events)
    return MatmulReport(
        name=name, m=m, k=k, n=n, count=count, stationary=stationary,
        tiles=T * count, rounds=rounds * count,
        compute_cycles=compute_cycles * count,
        reprogram_cycles=total_reprogram_cycles,
        cost=total, program_cost=program, freq_hz=am.freq_hz,
        macs_per_cycle_peak=engine.macs_per_cycle)


@dataclasses.dataclass(frozen=True)
class RoundSlice:
    """One round of ``round_timeline``: where its compute and RRAM
    programming sit on the wall clock, in engine cycles."""
    index: int
    compute_start: float
    compute_cycles: float
    program_start: float
    program_cycles: float
    #: program time the buffering mode could not hide (== this round's
    #: contribution to MatmulReport.reprogram_cycles at count=1)
    exposed_cycles: float

    @property
    def compute_end(self) -> float:
        return self.compute_start + self.compute_cycles


def round_timeline(m: float, k: int, n: int, engine: EngineConfig = None, *,
                   stationary: bool = True) -> List[RoundSlice]:
    """The round walk of one pass (count=1) as an explicit timeline.

    ``map_matmul`` accounts the overlap recurrence
    ``start_{r+1} = start_r + c_r + max(0, p_{r+1} − c_r)`` in closed
    form; this renders the same walk round by round so engine schedules
    can be *looked at* (``repro_torch.obs.trace.round_walk_chrome_trace``
    turns the slices into a Perfetto timeline).  Semantics mirror
    ``map_matmul`` exactly: a stationary matmul's round-0 tiles are
    preloaded (initial residency, not a stall); serial mode exposes
    every later round's program time in full; double-buffered mode
    programs round r+1 into the shadow plane while round r computes and
    exposes only the ``max(0, p − c)`` tail.  Consistency with
    ``MatmulReport`` (count=1 compute/reprogram cycle totals) is pinned
    by the reference's ``tests/test_obs.py``.
    """
    engine = engine or EngineConfig()
    am = engine.array_model
    df = get_dataflow(engine.dataflow)
    A = engine.arrays
    classes = sorted(_tile_classes(k, n),
                     key=lambda c: (df.mult_cycles(m, c[0], c[1]),
                                    c[0], c[1]),
                     reverse=True)
    T = sum(c[2] for c in classes)
    if T == 0 or m <= 0:
        return []
    bounds = []
    cum = 0
    for kt, nw, cnt in classes:
        bounds.append((cum, cum + cnt, kt, nw))
        cum += cnt

    def _class_at(idx: int) -> Tuple[int, int]:
        for lo, hi, kt, nw in bounds:
            if lo <= idx < hi:
                return kt, nw
        return bounds[-1][2], bounds[-1][3]

    rounds = math.ceil(T / A)
    apb, ports = engine.arrays_per_bank, engine.write_ports
    free = engine.free_programming
    # round 0 of a stationary matmul is initial residency, never a stall
    preloaded = stationary and not free
    out: List[RoundSlice] = []
    t = 0.0
    prev_c_start = 0.0
    for r in range(rounds):
        lo, hi = r * A, min(T, (r + 1) * A)
        kt0, nw0 = _class_at(lo)
        c_r = df.mult_cycles(m, kt0, nw0)
        p_r = 0.0
        if not free and not (r == 0 and preloaded):
            p_r = _round_program_cycles(bounds, lo, hi, apb, ports, am)
        if engine.double_buffered:
            # round r's writes start with round r−1's compute (round 0
            # has nothing to hide behind)
            p_start = prev_c_start if r > 0 else 0.0
            exposed = max(0.0, p_r - (t - p_start)) if p_r else 0.0
            c_start = t + exposed
        else:
            p_start = t
            exposed = p_r
            c_start = t + p_r
        out.append(RoundSlice(r, c_start, c_r, p_start, p_r, exposed))
        prev_c_start = c_start
        t = c_start + c_r
    return out


@dataclasses.dataclass(frozen=True)
class WorkloadReport:
    """A whole workload (matmul inventory) mapped onto one engine."""
    engine: EngineConfig
    per_matmul: Tuple[MatmulReport, ...]

    @property
    def macs(self) -> float:
        return sum(r.macs for r in self.per_matmul)

    @property
    def compute_cycles(self) -> float:
        return sum(r.compute_cycles for r in self.per_matmul)

    @property
    def reprogram_cycles(self) -> float:
        return sum(r.reprogram_cycles for r in self.per_matmul)

    @property
    def total_cycles(self) -> float:
        return self.compute_cycles + self.reprogram_cycles

    @property
    def latency_s(self) -> float:
        return self.total_cycles / self.engine.freq_hz

    @property
    def energy_j(self) -> float:
        return sum(r.cost.energy_j for r in self.per_matmul)

    @property
    def energy_breakdown_j(self) -> Dict[str, float]:
        out = {"read": 0.0, "mult": 0.0, "accum": 0.0, "reprogram": 0.0}
        for r in self.per_matmul:
            out["read"] += r.cost.e_read_j
            out["mult"] += r.cost.e_mult_j
            out["accum"] += r.cost.e_accum_j
            out["reprogram"] += r.cost.e_reprogram_j
        return out

    @property
    def utilization(self) -> float:
        denom = self.total_cycles * self.engine.macs_per_cycle
        return self.macs / denom if denom else 0.0

    @property
    def achieved_gops(self) -> float:
        return (oc.OPS_PER_MAC * self.macs / self.latency_s / 1e9
                if self.latency_s else 0.0)

    @property
    def achieved_tops_per_watt(self) -> float:
        return (oc.OPS_PER_MAC * self.macs / self.energy_j / 1e12
                if self.energy_j else 0.0)

    @property
    def macro_tops_per_watt(self) -> float:
        return self.achieved_gops / 1e3 / self.engine.macro_power_w

    @property
    def gops_per_mm2(self) -> float:
        return self.achieved_gops / self.engine.area_mm2

    @property
    def efficiency_vs_peak(self) -> float:
        return self.achieved_gops / self.engine.peak_gops


def map_workload(entries: Iterable, engine: EngineConfig = None, *,
                 include_attention: bool = True,
                 trace: Optional[Trace] = None) -> WorkloadReport:
    """Map a matmul inventory (``roofline.model.MatmulShape``s) onto
    ``engine``; matmuls execute sequentially (the engine is one resource).

    ``include_attention=False`` drops the non-stationary entries — the
    deployment where activation×activation products stay on the host and
    the OISMA engine only serves resident-weight matmuls.
    """
    engine = engine or EngineConfig()
    reports = []
    for e in entries:
        if not include_attention and not e.stationary:
            continue
        reports.append(map_matmul(
            e.m, e.k, e.n, engine, name=e.name, stationary=e.stationary,
            count=e.count, trace=trace))
    return WorkloadReport(engine=engine, per_matmul=tuple(reports))


def map_model(cfg, shape, engine: EngineConfig = None, *,
              include_attention: bool = False,
              trace: Optional[Trace] = None) -> WorkloadReport:
    """Map one model×shape cell's matmul workload onto ``engine``."""
    from repro_torch.roofline.model import matmul_inventory
    return map_workload(matmul_inventory(cfg, shape), engine,
                        include_attention=include_attention, trace=trace)


# ---------------------------------------------------------------------------
# validation against the closed-form cost model / paper endpoints
# ---------------------------------------------------------------------------

#: published endpoints (paper abstract + Table III)
PAPER_ENDPOINTS = {
    "e_mac_pj": oc.E_MAC_PJ,                    # 2.2452 (paper: 2.245)
    "peak_gops_1mb_180nm": oc.PEAK_GOPS_1MB_180NM,   # 819.2
    "tops_per_watt_180nm_array": 0.891,
    "tops_per_watt_180nm_macro": 0.789,
    "gops_per_mm2_180nm": 3.98,
    "tops_per_watt_22nm": 89.5,
    "tops_per_mm2_22nm": 3.28,
}


def ideal_workload(engine: EngineConfig, m: int = 4096):
    """An (m, k, n) that exactly fills every array with full tiles."""
    a = engine.arrays
    tk = max(1, int(math.sqrt(a)))
    while a % tk:
        tk -= 1
    return m, arr.ROWS_PER_ARRAY * tk, arr.WORDS_PER_ROW * (a // tk)


def validate() -> List[Tuple[str, float, float, float]]:
    """Simulate the paper's ideal operating points and compare.

    Returns (metric, simulated, reference, relative_error) rows; the
    acceptance bar (tests/test_sim.py, tests/test_torch_sim.py) is
    < 0.5 % on every row.
    """
    rows = []

    def add(metric, sim):
        ref = PAPER_ENDPOINTS[metric]
        rows.append((metric, sim, ref, abs(sim - ref) / ref))

    e180 = EngineConfig(technology_nm=180, free_programming=True)
    m, k, n = ideal_workload(e180)
    r = map_matmul(m, k, n, e180)
    add("e_mac_pj", r.energy_per_mac_pj)
    add("peak_gops_1mb_180nm", r.achieved_gops)
    add("tops_per_watt_180nm_array", r.achieved_tops_per_watt)
    w = WorkloadReport(engine=e180, per_matmul=(r,))
    add("tops_per_watt_180nm_macro", w.macro_tops_per_watt)
    add("gops_per_mm2_180nm", w.gops_per_mm2)

    e22 = EngineConfig(technology_nm=22, free_programming=True)
    r22 = map_matmul(m, k, n, e22)
    w22 = WorkloadReport(engine=e22, per_matmul=(r22,))
    add("tops_per_watt_22nm", r22.achieved_tops_per_watt)
    add("tops_per_mm2_22nm", w22.gops_per_mm2 / 1e3)
    return rows
