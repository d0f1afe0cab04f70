"""NVIDIA H100 hardware constants for the roofline model (per card).

Values from NVIDIA's H100 Tensor Core GPU data sheet, SXM5 part, dense
rates (no structured sparsity), at the card's full power limit of
700 W.  A card set below 700 W (``nvidia-smi --query-gpu=power.limit``)
runs slower under load, so a share of these peaks is stated beside the
card's power limit.  They are the data sheet's, not measured here.

The collective term's link is NVLink (fourth generation): 900 GB/s a card
in all, 450 GB/s each way.  The machine the port's card checks run on
holds one card, so that term is never measured there.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16/fp16 tensor cores
PEAK_OPS_INT8 = 1979e12       # OP/s, int8 tensor cores (the BP products)
PEAK_FLOPS_F32 = 67e12        # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
NVLINK_BW = 450e9             # bytes/s, NVLink, each way
