"""The Bent-Pyramid number system and the OISMA cost model.

Submodules:
  bp          — the BP datasets, their design-time search, the plane
                tables the kernels read, and the stochastic reference
  bp_matmul   — BP matmuls in plain PyTorch (LUT / bitplane / low-rank)
  quantize    — BP + FP8 (E4M3) quantisers
  oisma_cost  — OISMA architectural energy/area/throughput model
"""
from repro_torch.core import bp, bp_matmul, oisma_cost, quantize

__all__ = ["bp", "bp_matmul", "oisma_cost", "quantize"]
