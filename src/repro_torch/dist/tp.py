"""Tensor parallelism over the mesh's "model" axis.

The reference's ``repro.dist.tp`` on the port's meshes.  A plan
(``plan_stage_tp``) decides, per config and mesh, which weight dims split
over the TP axes (head-aligned splits, not raw divisibility of flattened
dims); ``stage_param_specs`` turns it into per-leaf placements of the
stage-stacked layer tree, and ``layer_placements`` / ``param_placements``
into those of the port's train state (one piece of each leaf a rank).
``use_stage_tp`` installs the plan for the model layers, which then run
on their local weight pieces: ``dense(tp="col")`` (a column-parallel
projection: "g" on its f32 input, so that each projection's input
gradient is summed before its one cast) and ``dense(tp="row")`` (a
row-parallel one: "f" on its output), the fused MLP likewise, and
``tp_gather`` / ``tp_psum`` where the MoE layer and MLA split outside
``dense``.

Torch differentiates each rank on its own, as the reference's
hand-rolled VJP regime does, so the collectives are always the Megatron
pair, each a ``torch.autograd.Function`` over the model group:

  * "f" (``tp_psum``): all-reduce forward, identity backward;
  * "g" (``tp_gather``): identity forward, all-reduce backward.

A replicated leaf consumed *inside* sharded compute gets a partial
gradient on each rank, so the layers pass it through "g" as well: the
qk-norm gammas, grouped-kv ``wk``/``wv`` (and their biases) in
``KV_GROUP``, and the MoE router's combine weights.  A replicated value
computed before the split (the layer norms, MLA's latents) gets whole
gradients from the "g" at the split.

**Where the BP scale is taken** (``bp8_fused``; the kernels take absmax
inside): two rules, one a regime.

  * *Per shard* (``exact=False``, the pipelined mesh): the reference's
    layers run on local pieces inside ``shard_map``, so each rank's
    absmax covers its own weight piece, and the row-parallel ``down`` /
    ``wo`` also its own activation piece; their output is cast to the
    activations' type and then summed ("f"), as the reference's psum
    follows ``dense``.  The sharded model is a different function from
    the unsharded one, and the port computes the reference's.
  * *Global* (``exact=True``, a stage-free mesh): the reference's "model"
    axis is GSPMD's, which keeps the unsharded program's meaning.  Every
    scale is reduced (MAX) over the mesh's batch and model axes before
    its kernel (``global_scales``) and the row-parallel partial outputs
    are summed in f32 before the cast: the integer K sums are exact on
    each rank, so the step differs from the unsharded one only by f32
    rounding.  ``bp8``/``bp8_lowrank`` (no kernel) take their scales per
    piece in both regimes, and a split ``bf16`` matmul runs in f32 and
    sums its partials before one cast in both (no scale is involved).

The plan lives in a process-wide slot, not a thread-local one: autograd
runs a CUDA backward, and the recomputation of a remat'd layer in it, on
a thread of its own, which must see the plan the forward saw.

Nothing here touches a device or a process group at import.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as _ops

#: kv sharding modes for GQA under head-parallel attention
KV_SHARD, KV_GROUP, KV_NONE = "shard", "group", "none"


@dataclasses.dataclass(frozen=True)
class StageTPPlan:
    """What splits over the TP axes inside one stage (the reference's).

    ``kv_mode`` for GQA attention: "shard" (kv_heads % tp == 0: wk/wv
    split like wq), "group" (tp % kv_heads == 0: wk/wv replicated, each
    rank slices the kv head its q-head block maps to), "none" (no
    head-aligned split; attention replicates)."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    shard_heads: bool
    kv_mode: str
    shard_ffn: bool
    shard_experts: bool
    shard_shared: bool

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def plan_stage_tp(cfg: ModelConfig, mesh,
                  axes: Tuple[str, ...] = ("model",)
                  ) -> Optional[StageTPPlan]:
    """TP plan for ``cfg``'s decoder layers on ``mesh`` (anything with a
    ``shape`` mapping), or None when no axis of ``axes`` has more than
    one rank."""
    sizes = dict(mesh.shape)
    present = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not present:
        return None
    tp = 1
    for a in present:
        tp *= sizes[a]
    shard_heads = cfg.num_heads % tp == 0
    if cfg.attention_type == "mla" or not shard_heads:
        kv_mode = KV_NONE
    elif cfg.num_kv_heads % tp == 0:
        kv_mode = KV_SHARD
    elif tp % cfg.num_kv_heads == 0:
        kv_mode = KV_GROUP
    else:
        shard_heads = False  # no head-aligned split of q vs kv exists
        kv_mode = KV_NONE
    sdff = cfg.moe_d_ff * cfg.num_shared_experts
    return StageTPPlan(
        axes=present,
        sizes=tuple(sizes[a] for a in present),
        shard_heads=shard_heads,
        kv_mode=kv_mode,
        shard_ffn=cfg.d_ff % tp == 0,
        shard_experts=cfg.num_experts > 0 and cfg.num_experts % tp == 0,
        shard_shared=sdff > 0 and sdff % tp == 0,
    )


# ---------------------------------------------------------------------------
# the ambient plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPRuntime:
    """The installed plan with the mesh it runs on: ``index`` is this
    rank's row-major index over the plan's axes; ``exact`` the global
    scale regime (module docstring)."""
    plan: StageTPPlan
    mesh: Any
    exact: bool

    @property
    def index(self) -> int:
        return self.mesh.index(self.plan.axes)


_SLOT = [None]     # process-wide: autograd's device threads read it too


def current_tp() -> Optional[TPRuntime]:
    """The installed plan, or None outside any ``use_stage_tp``."""
    return _SLOT[0]


@contextlib.contextmanager
def use_stage_tp(plan: Optional[StageTPPlan], mesh=None, *,
                 exact: bool = False):
    """Install ``plan`` over ``mesh`` while the layers run, forward and
    backward (None = no TP); nests, restoring the previous one."""
    prev = _SLOT[0]
    if plan is not None and mesh is None:
        raise ValueError("a TP plan runs on a mesh")
    _SLOT[0] = TPRuntime(plan, mesh, exact) if plan is not None else None
    try:
        yield _SLOT[0]
    finally:
        _SLOT[0] = prev


@contextlib.contextmanager
def global_scales(mesh, axes: Tuple[str, ...] = ("data", "model")):
    """Reduce every BP scale (MAX) over ``axes`` of ``mesh`` before its
    kernel: the unsharded program's scales on a stage-free mesh."""
    if mesh.size(axes) == 1:
        yield
        return
    with _ops.reduced_scales(lambda s: mesh.all_reduce(s, axes, "max")):
        yield


# ---------------------------------------------------------------------------
# the Megatron f / g operators
# ---------------------------------------------------------------------------

class _AllReduceF(torch.autograd.Function):
    """"f": forward all-reduce, backward identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        out = x.clone()
        mesh.all_reduce(out, axes)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceG(torch.autograd.Function):
    """"g": forward identity, backward all-reduce."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.mesh.all_reduce(g, ctx.axes)
        return g, None, None


def region_psum(x: torch.Tensor, mesh, axes: Tuple[str, ...]
                ) -> torch.Tensor:
    """Row-parallel output reduction over ``axes`` ("f")."""
    return _AllReduceF.apply(x, mesh, tuple(axes))


def region_gather(x: torch.Tensor, mesh, axes: Tuple[str, ...]
                  ) -> torch.Tensor:
    """Column-parallel input marker over ``axes`` ("g")."""
    return _AllReduceG.apply(x, mesh, tuple(axes))


def tp_psum(x: torch.Tensor, tpc: Optional[TPRuntime] = None
            ) -> torch.Tensor:
    """"f" over the plan's axes; identity when no plan is installed."""
    tpc = tpc or current_tp()
    if tpc is None:
        return x
    return region_psum(x, tpc.mesh, tpc.plan.axes)


def tp_gather(x: torch.Tensor, tpc: Optional[TPRuntime] = None
              ) -> torch.Tensor:
    """"g" over the plan's axes; identity when no plan is installed."""
    tpc = tpc or current_tp()
    if tpc is None:
        return x
    return region_gather(x, tpc.mesh, tpc.plan.axes)


def tp_index(tpc: TPRuntime) -> int:
    """This rank's row-major index within the TP group."""
    return tpc.index


def group_kv_head(cfg: ModelConfig, tp: int, index: int) -> int:
    """In "group" mode, the kv head that rank ``index`` of ``tp`` reads:
    the one its contiguous block of q heads maps to."""
    h = cfg.num_heads
    return (index * (h // tp)) // (h // cfg.num_kv_heads)


# ---------------------------------------------------------------------------
# placements of the layer stack
# ---------------------------------------------------------------------------

def _map_axis(plan: StageTPPlan, name: Optional[str], used: set,
              *, shard: bool):
    if not shard or name is None:
        return None
    if set(plan.axes) & used:
        return None  # each mesh axis at most once per placement
    used.update(plan.axes)
    return plan.axes if len(plan.axes) > 1 else plan.axes[0]


def _leaf_spec(plan: StageTPPlan, key: str, ax: Tuple[Optional[str], ...],
               axis_name: Optional[str], in_moe: bool) -> tuple:
    if not ax or ax[0] != "stack":
        raise ValueError(f"{key}: a layer leaf's axes start with 'stack', "
                         f"got {ax}")
    entries: list = [axis_name, None]  # (S, L_per, ...) leading dims
    used: set = set()
    for name in ax[1:]:
        if in_moe:
            if key == "router":
                shard = False  # routing needs every expert's logits
            elif key.startswith("shared_"):
                shard = name == "ffn" and plan.shard_shared
            else:
                shard = name == "experts" and plan.shard_experts
        else:
            shard = ((name == "heads" and plan.shard_heads)
                     or (name == "kv_heads" and plan.kv_mode == KV_SHARD)
                     or (name == "ffn" and plan.shard_ffn))
        entries.append(_map_axis(plan, name, used, shard=shard))
    return tuple(entries)


def _walk(node: Any, fn, key: str = "", in_moe: bool = False):
    if isinstance(node, dict):
        return {k: _walk(v, fn, k, in_moe or k == "moe")
                for k, v in node.items()}
    return fn(key, tuple(node), in_moe)


def stage_param_specs(plan: StageTPPlan, axes: Any,
                      axis_name: str = "stage") -> Any:
    """Per-leaf placements of the stage-stacked (S, L_per, ...) layer
    tree, from its unstacked logical-axes tree (each leaf's axes start
    with "stack"): the reference's at-rest specs of the pipeline."""
    return _walk(axes, lambda k, ax, moe: _leaf_spec(plan, k, ax,
                                                     axis_name, moe))


def layer_placements(plan: Optional[StageTPPlan], axes: Any,
                     stage_axis: Optional[str] = "stage") -> Any:
    """Placements of the unstacked (L, ...) layer tree the port keeps: the
    layers over ``stage_axis`` (None: every rank holds every layer), the
    plan's TP dims over its axes (None: no TP)."""
    def leaf(key, ax, moe):
        if plan is None:
            return (stage_axis,) + (None,) * (len(ax) - 1)
        spec = _leaf_spec(plan, key, ax, stage_axis, moe)
        return (spec[0],) + spec[2:]
    return _walk(axes, leaf)


def param_placements(schema_axes: Any, plan: Optional[StageTPPlan],
                     stage_axis: Optional[str]) -> Any:
    """Placements of a decoder's whole param tree: its ``layers`` stack by
    ``layer_placements``, every other leaf (embedding, head, final norm,
    the dense first layers) whole on every rank."""
    out = {}
    for k, v in schema_axes.items():
        if k == "layers":
            out[k] = layer_placements(plan, v, stage_axis)
        else:
            out[k] = _walk(v, lambda key, ax, moe: (None,) * len(ax))
    return out
