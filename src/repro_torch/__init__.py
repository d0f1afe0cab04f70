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
observability layer and the traffic harness.  The training slice adds
straight-through gradients over the kernels, the loss, AdamW, the data
pipeline, checkpoints in the reference's on-disk format and the trainer.
Later slices add meshes of ranks (tensor, pipeline and sequence
parallelism) and the paper's own engine model: the BP datasets and the
stochastic reference of the in-array multiply, the OISMA cost model, the
tile simulator and the analytic roofline on the H100's peaks.

  configs/   ModelConfig and the ten archs' configs, ShapeConfig, SHAPES
  core/      the BP datasets and their design-time search, plane
             thresholds, the stochastic reference (AND and popcount), BP
             and E4M3 quantisation, the lut/bitplane/lowrank BP matmuls,
             and the OISMA cost model (``oisma_cost``)
  kernels/   seven CUDA kernels (``csrc/``), their wrappers and plain
             PyTorch versions, the ``oisma_matmul``/``oisma_mlp`` ops, the
             ``kernels.*`` counters and the analytic traffic model
  models/    params, layers, GQA attention, ``DecoderModel`` (serving
             entry points and the training loss), converters from and to
             the reference's param tree and train state
  obs/       metrics registry, tracer (and the simulator's timelines),
             shape watchdog
  serve/     scheduler, paged KV cache, sampling, the paged and lock-step
             engines, CUDA graphs of their entry points, traffic harness
  optim/     AdamW, the int8 error-feedback codec
  data/      the seeded synthetic data pipeline
  train/     ``TrainPlan``, the train step, the trainer
  ckpt/      checkpoints (the reference's format) and the async manager
  runtime/   failure injection, straggler monitor, supervisors
  dist/      the sharding rules, tensor parallelism and the GPipe/1F1B
             pipeline over meshes of ranks
  launch/    the serving and training CLIs, meshes of ranks over
             ``torch.distributed`` and their launcher
  sim/       the OISMA engine simulator: one array, dataflows, the
             weight-stationary mapper, multi-engine scale-out, traces
  roofline/  the H100's data-sheet peaks, roofline terms, and the
             analytic per-cell FLOP, byte and matmul-inventory model
  utils/     ``metrics``, the shim over ``obs.registry``
"""
