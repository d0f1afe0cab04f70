"""Distributed training and serving over meshes of ranks
(``torch.distributed``).

  * :mod:`repro_torch.dist.sharding`: logical-axis rules -> per-leaf
    placements, and cutting a leaf into a rank's piece and back;
  * :mod:`repro_torch.dist.tp`: tensor parallelism over "model" (the
    plan, the placements, the Megatron f/g operators, the two BP scale
    rules);
  * :mod:`repro_torch.dist.pipeline`: pipeline parallelism over "stage"
    (stage stacking, the GPipe and 1F1B timetables, their executor);
  * :mod:`repro_torch.dist.seq`: sequence parallelism over "seq" (ring
    attention, GQA and MLA, under both ring schedules, and the layouts
    of a seq-sharded KV cache and of a prompt's rows);
  * :mod:`repro_torch.dist.serving`: tensor-parallel serving of the
    decoders on a stage-free ("data", "model") mesh under the reference's
    "prefill" and "decode" rules (the weights', cache's and vocabulary's
    pieces, the entry points' layout).

The meshes themselves are ``repro_torch.launch.mesh``'s.  Nothing here
touches a device or a process group at import.
"""
from repro_torch.dist import pipeline, seq, serving, sharding, tp  # noqa: F401
