"""Device/interconnect calibration: the one place the assumptions live.

The OISMA paper publishes read/compute energies (Table II) but not RRAM
*write* costs or any multi-engine interconnect, so the simulator's
reprogramming and scale-out models rest on documented assumptions.

RRAM writes — two numbers, typical for 1T1R HfO2 RRAM:

* **10 pJ/bit** write energy — SET/RESET pulse energy per cell.  Device-
  limited (filament physics), so it does NOT scale with the CMOS node the
  periphery is built in.
* **1 µs per wordline row** program time — one program-verify pulse per
  row.  Fixed in *seconds*; the stall it causes in *cycles* therefore
  grows with the clock frequency of scaled nodes.

Everything in ``repro_torch.sim`` that prices a weight (re)program reads these
two numbers from one :class:`RRAMWriteCalibration` instance, threaded
``EngineConfig -> ArrayModel -> program_tile``.  To study a different
device point (e.g. if the paper group publishes measurements, per the
ROADMAP calibration item), override at the engine level::

    cal = RRAMWriteCalibration(write_fj_per_bit=2_000.0,
                               write_s_per_row=100e-9,
                               source="foundry X measured")
    EngineConfig(write_cal=cal)

and every tile class, stall and energy row downstream follows.

Multi-engine interconnect (``repro_torch.sim.scaleout``) — a per-hop
energy/latency model of the network-on-chip that carries partial-sum
accumulation traffic between engines.  The three numbers (hop energy per
byte, hop latency, link bandwidth) are typical for a 2D-mesh NoC at
mature nodes; like the write numbers they are assumptions, tagged with a
``source`` string that the tables carry, and overridable in one place::

    ClusterConfig(engines=8,
                  interconnect=InterconnectCalibration(
                      hop_energy_fj_per_byte=50.0, source="measured"))
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RRAMWriteCalibration:
    """Write energy/time of the 1T1R RRAM cells (assumed, not published)."""
    write_fj_per_bit: float = 10_000.0   # 10 pJ/bit
    write_s_per_row: float = 1e-6        # 1 µs program pulse per row
    #: provenance tag carried into reports/tables
    source: str = "assumed: typical 1T1R HfO2 RRAM (paper publishes no writes)"


#: the repo-wide default; import this rather than re-literal-ing the numbers
DEFAULT_WRITE_CAL = RRAMWriteCalibration()


@dataclasses.dataclass(frozen=True)
class InterconnectCalibration:
    """Per-hop cost of the inter-engine NoC (assumed, not published).

    ``repro_torch.sim.scaleout`` charges one hop per partial-sum block moved in
    a binary-tree reduction; energy is device/wire-limited like the RRAM
    writes, so it does NOT scale with the CMOS node by default.
    """
    hop_energy_fj_per_byte: float = 180.0  # router + wire, ~0.18 pJ/B/hop
    hop_latency_s: float = 5e-9            # router traversal + flight time
    link_bytes_per_s: float = 8e9          # 8 GB/s per engine-to-engine link
    #: provenance tag carried into reports/tables
    source: str = "assumed: 2D-mesh NoC (paper models a single engine)"


#: the repo-wide default interconnect assumption set
DEFAULT_INTERCONNECT_CAL = InterconnectCalibration()
