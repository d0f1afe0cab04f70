"""Roofline terms of one (arch, shape, mesh) cell, on the H100.

Three terms, all in seconds:

  compute    = FLOPs / (cards * peak bf16 FLOP/s)
  memory     = HBM bytes / (cards * HBM bytes/s)
  collective = collective bytes a card / NVLink bytes/s (each way)

with the peaks of ``repro_torch.roofline.hw``.  The counts come from the
analytic formulas of ``roofline.model`` (``analytic_cell``).  The
reference also parses collective bytes out of XLA's compiled HLO for its
dry-run; that parser comes with the port of the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.roofline import hw


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # whole-program FLOPs (all chips)
    hbm_bytes: float             # whole-program HBM traffic (all chips)
    coll_bytes_per_chip: float   # per-card link traffic
    chips: int
    model_flops: float = 0.0     # 6*N*D useful FLOPs for the workload
    pipeline_bubble: float = 0.0  # (S-1)/(M+S-1) idle fraction; 0 = no PP

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * hw.PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * hw.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / hw.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap),
        stretched by the pipeline bubble when the cell is pipelined: the
        fill/drain triangles idle every stage for ``pipeline_bubble`` of
        the schedule, so achievable time is ideal / (1 - bubble)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if self.pipeline_bubble:
            t /= (1.0 - self.pipeline_bubble)
        return t

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the USEFUL flops achieve at the roofline step
        time — the score: model_flops / (step_time * chips * peak)."""
        t = self.step_time
        if not t:
            return 0.0
        return self.model_flops / (t * self.chips * hw.PEAK_FLOPS_BF16)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "chips": self.chips, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "pipeline_bubble": self.pipeline_bubble,
            "step_time": self.step_time,
        }


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE); decode counts one token/seq."""
    from repro_torch.models import build
    from repro_torch.models.params import param_count
    n_params = param_count(build(cfg).schema())
    n_active = n_params
    if cfg.num_experts:
        # replace routed-expert params with the activated fraction
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        routed = moe_layers * cfg.num_experts * per_expert
        active = moe_layers * cfg.num_experts_per_tok * per_expert
        n_active = n_params - routed + active
    # embeddings don't multiply
    n_active -= cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
