"""repro_torch.sim — tile-level OISMA engine simulator + workload mapper.

A copy of the reference's ``repro/sim`` (pure Python, the same
expressions in the same order, so every report is equal to the
reference's, float for float).  Where ``repro_torch.core.oisma_cost`` is
a closed-form peak model, this package answers what a *real* MatMul
workload achieves on a concrete engine:

  array.py     one 4 kB array's timing/energy (Table II decomposition,
               RRAM reprogramming costs, 180 nm / 22 nm scaling)
  dataflow.py  input-stationary (VMM) vs output-stationary (single-mult)
               schedules; the 17.6 % VMM saving derived from toggle counts
  mapper.py    weight-stationary tiling of (M, K, N) matmuls — and whole
               models via roofline.model.matmul_inventory — onto an
               EngineConfig, with utilization, stalls (serial or
               double-buffered/overlapped reprogramming), and the
               read/mult/accum/reprogram energy budget
  scaleout.py  multi-engine clusters: one inventory sharded over E
               engines with per-hop accumulation-traffic costing and the
               scaling-efficiency curve
  trace.py     per-tile-class event records + summarize() for the tables

``validate()`` pins the simulator to the paper's published endpoints
(E_MAC, 819.2 GOPS, 0.789/0.891 TOPS/W, 3.98 GOPS/mm², 89.5 TOPS/W,
3.28 TOPS/mm²) to < 0.5 %.  See docs/oisma_engine.md.
"""
from repro_torch.sim.array import ArrayModel, TileCost
from repro_torch.sim.calibration import (DEFAULT_INTERCONNECT_CAL,
                                   DEFAULT_WRITE_CAL,
                                   InterconnectCalibration,
                                   RRAMWriteCalibration)
from repro_torch.sim.dataflow import DATAFLOWS, Dataflow, get_dataflow, \
    vmm_saving_fraction
from repro_torch.sim.mapper import (EngineConfig, MatmulReport, WorkloadReport,
                              ideal_workload, map_matmul, map_model,
                              map_workload, validate)
from repro_torch.sim.scaleout import (ClusterConfig, ClusterMatmulReport,
                                ClusterReport, map_cluster,
                                map_model_cluster, scaling_curve,
                                shard_matmul)
from repro_torch.sim.trace import TileEvent, Trace

__all__ = [
    "ArrayModel", "TileCost", "DEFAULT_WRITE_CAL", "RRAMWriteCalibration",
    "DEFAULT_INTERCONNECT_CAL", "InterconnectCalibration",
    "DATAFLOWS", "Dataflow", "get_dataflow",
    "vmm_saving_fraction", "EngineConfig", "MatmulReport", "WorkloadReport",
    "ideal_workload", "map_matmul", "map_model", "map_workload", "validate",
    "ClusterConfig", "ClusterMatmulReport", "ClusterReport", "map_cluster",
    "map_model_cluster", "scaling_curve", "shard_matmul",
    "TileEvent", "Trace",
]
