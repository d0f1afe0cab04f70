"""repro_torch — the OISMA reproduction ported to PyTorch and CUDA (H100).

The JAX/Pallas package ``repro`` is the reference; this package grows
beside it slice by slice and imports nothing from it (nor from jax).
The first slice serves a GQA decoder through the paged engine with the
paper's technique on: ``matmul_mode="bp8_fused"`` (every projection is a
Bent-Pyramid matmul, encoded on the fly inside a hand-written CUDA
kernel) and ``kv_quant="bp8"`` (int8 BP codes in the KV cache, decoded by
a fused attention kernel).  The second adds the unfused OISMA pipeline
(BP quantise, codes matmul and popcount periphery kernels) and the
``bp8``, ``bp8_lowrank`` and ``fp8`` matmul modes.  Later slices run the
paged engine's entry points as CUDA graphs and add temperature sampling
(threefry, bit for bit the reference's), the lock-step engine, the
observability layer and the traffic harness.

  configs/   ModelConfig and the two decoder configs of the slice
  core/      the BP datasets, plane thresholds, BP and E4M3 quantisation,
             and the lut/bitplane/lowrank BP matmuls
  kernels/   seven CUDA kernels (``csrc/``), their wrappers and plain
             PyTorch versions, the ``oisma_matmul``/``oisma_mlp`` ops, the
             ``kernels.*`` counters and the analytic traffic model
  models/    params, layers, GQA attention, ``DecoderModel``, converter
             from the reference's param tree
  obs/       metrics registry, tracer, shape watchdog
  serve/     scheduler, paged KV cache, sampling, the paged and lock-step
             engines, CUDA graphs of their entry points, traffic harness
  launch/    the serving CLI
"""
