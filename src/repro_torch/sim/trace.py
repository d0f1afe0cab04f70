"""Per-tile event records for an engine mapping, plus table rendering.

The mapper accounts tiles in closed form by (k_rows, n_words) class, so a
trace holds one event per (matmul, tile-class, kind) with a ``tiles``
multiplicity rather than one event per physical tile — bounded output even
for billion-MAC workloads, while preserving the full cycle/energy
breakdown.  ``summarize()`` reduces a trace to the totals that
the reference's ``scripts/make_tables.py`` renders next to the paper tables.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

from repro_torch.sim.array import TileCost


@dataclasses.dataclass(frozen=True)
class TileEvent:
    matmul: str          # inventory entry name ("mlp.up", "logits", ...)
    kind: str            # "compute" | "reprogram" | "program"
    k_rows: int          # tile rows (wordlines used)
    n_words: int         # tile width in BP8 words
    tiles: float         # how many physical tiles this event class covers
    #: TOTAL cost over all ``tiles``; .cycles is summed per-tile busy time
    #: (array occupancy) — wall-clock lives on MatmulReport
    cost: TileCost

    def as_row(self) -> str:
        return (f"{self.matmul},{self.kind},{self.k_rows}x{self.n_words},"
                f"tiles={self.tiles:g},cycles={self.cost.cycles:.3g},"
                f"energy_j={self.cost.energy_j:.4g}")


class Trace:
    """Ordered collection of TileEvents for one mapped workload."""

    def __init__(self):
        self.events: List[TileEvent] = []

    def add(self, event: TileEvent) -> None:
        self.events.append(event)

    def extend(self, events: Iterable[TileEvent]) -> None:
        self.events.extend(events)

    def __len__(self) -> int:
        return len(self.events)

    def total(self) -> TileCost:
        t = TileCost(0.0, 0.0)
        for e in self.events:
            t = t + e.cost
        return t

    def summarize(self) -> Dict[str, float]:
        """Totals + breakdowns for table rendering.

        energy_*_j keys follow the read/mult/accum/reprogram budget;
        cycles_* splits compute from programming stalls.
        """
        out: Dict[str, float] = {
            "events": float(len(self.events)), "tiles": 0.0, "macs": 0.0,
            # per-tile busy cycles summed over ALL tiles (array occupancy);
            # wall-clock cycles live on MatmulReport/WorkloadReport, which
            # take per-round maxima — on an A-array engine occupancy can
            # legitimately be up to A x the wall-clock
            "occupancy_cycles_compute": 0.0,
            "occupancy_cycles_reprogram": 0.0,
            "energy_read_j": 0.0, "energy_mult_j": 0.0,
            "energy_accum_j": 0.0, "energy_reprogram_j": 0.0,
            # initial weight residency, always reported separately here;
            # energy_j below is the steady-state total (read/mult/accum/
            # reprogram), matching WorkloadReport defaults
            "energy_program_j": 0.0,
        }
        for e in self.events:
            out["tiles"] += e.tiles
            out["macs"] += e.cost.macs
            if e.kind == "compute":
                out["occupancy_cycles_compute"] += e.cost.cycles
            elif e.kind == "reprogram":
                out["occupancy_cycles_reprogram"] += e.cost.cycles
            if e.kind == "program":
                out["energy_program_j"] += e.cost.e_reprogram_j
                continue
            out["energy_read_j"] += e.cost.e_read_j
            out["energy_mult_j"] += e.cost.e_mult_j
            out["energy_accum_j"] += e.cost.e_accum_j
            out["energy_reprogram_j"] += e.cost.e_reprogram_j
        out["energy_j"] = (out["energy_read_j"] + out["energy_mult_j"]
                           + out["energy_accum_j"]
                           + out["energy_reprogram_j"])
        return out
