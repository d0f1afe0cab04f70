"""Tensor-parallel serving of the decoders on a stage-free mesh.

The reference serves a decoder on a ("data", "model") mesh by jitting
``model.prefill`` / ``prefill_chunk`` / ``decode_step`` under
``use_rules(mesh, get_rules("prefill" | "decode", ...))``: GSPMD cuts the
weights, the KV cache and the vocabulary by the rules and keeps the
unsharded program's meaning.  Eager torch has no partitioner, so this
module does that work for the port:

  * ``use_tp_serving(mesh, phase, batch=...)`` installs, on every rank,
    the phase's rules (the "decode" rules fold "data" into "model" when
    the batch does not tile "data") with ``use_rules``; the decoder's
    entry points read them (:class:`ServingCtx`).  Each entry point then
    runs under ``call(model, batch, params, cache)``: the TP plan of
    ``dist.tp.plan_stage_tp`` over the axes the rules give "heads"
    (``("model",)``, or ``("data", "model")`` in the fold), installed
    with ``use_stage_tp(exact=True)``, and every BP scale reduced (MAX)
    over the axes that split a weight or the batch
    (``dist.tp.global_scales``): in ``bp8_fused`` one absmax covers all
    of a call's rows and a whole weight.
  * ``serve_params(model, params, mesh, rules)`` cuts a whole param tree
    into this rank's pieces: the layer stacks by the plan
    (``layer_placements(plan, axes, stage_axis=None)``), the embedding
    and an untied head by "vocab" over the rules' axes with the
    reference's divisibility fallback, the rest whole.
  * ``local_kv_heads`` names the kv heads a rank's cache holds, the
    layout ``DecoderModel.cache_spec`` gives a rank with its batch rows.

The entry points take the whole batch on every rank and return the
whole (B, V) logits on every rank, as the reference's jitted calls do;
each rank runs its rows (the rules' "batch" cut) on its weight pieces,
and its cache holds its piece.  Each call checks that the params are
this layout's pieces and the cache its rows and kv heads, and raises
otherwise.  A cache serves only under the layout it was made in: the
fold at a batch that does not tile "data" changes which kv heads a rank
holds between "prefill" and "decode", and the handover raises (serve
such a request under one phase's rules).

What this slice does not serve raises ``NotImplementedError`` naming
the ROADMAP item: the other families, a mixture-of-experts layer over a
batch split over "data" (its routing counts the whole batch), the
unfused BP modes (``bp8``, ``bp8_lowrank``: their scales are taken per
piece), and a ring or stages on the mesh.

Whether a serving block is open sits in a process-wide slot, as the
TP plan does; the mesh and the rules are ``use_rules``'.  Nothing here
touches a device or a process group at import.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch.utils import weak

from repro_torch.dist import sharding as shd
from repro_torch.dist import tp as mtp

#: the ROADMAP items that take what this slice refuses
FAMILIES_NEXT = "waits for ROADMAP Queue 1 item 5c(f)"
SERVING_NEXT = "waits for ROADMAP Queue 1 item 5c(g)"
RING_NEXT = "waits for ROADMAP Queue 1 item 5c(a)"

PHASES = ("prefill", "decode")


def serving_rules(mesh, phase: str, batch: int = 1) -> shd.Rules:
    """The reference's rules for ``phase``: "prefill", or "decode" at
    ``batch`` rows over the mesh's "data" axis."""
    if phase not in PHASES:
        raise ValueError(f"serving phase {phase!r}: one of {PHASES}")
    if phase == "prefill":
        return shd.get_rules("prefill")
    return shd.get_rules("decode", batch=batch,
                         data_size=dict(mesh.shape).get("data", 1))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def heads_axes(mesh, rules) -> Tuple[str, ...]:
    """The mesh axes of more than one rank the rules give "heads": the TP
    plan's axes."""
    sizes = dict(mesh.shape)
    return tuple(a for a in shd.Rules(rules).mesh_axes("heads")
                 if sizes.get(a, 1) > 1)


def serving_plan(cfg, mesh, rules) -> Optional[mtp.StageTPPlan]:
    """The TP plan of ``cfg``'s layers under ``rules`` (None: no axis of
    the rules' "heads" has more than one rank)."""
    return mtp.plan_stage_tp(cfg, mesh, heads_axes(mesh, rules))


def _dim_axes(mesh, rules, name: str, n: int) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that split a dim of ``n``
    named ``name``: the rules' own, after their presence and divisibility
    fallbacks."""
    sizes = dict(mesh.shape)
    return tuple(a for a in _axes(shd.partition_spec(mesh, rules, (n,),
                                                     (name,))[0])
                 if sizes[a] > 1)


def row_axes(mesh, rules, batch: int) -> Tuple[str, ...]:
    """The mesh axes a batch of ``batch`` rows splits over."""
    return _dim_axes(mesh, rules, "batch", batch)


def vocab_axes(mesh, rules, vocab: int) -> Tuple[str, ...]:
    """The mesh axes the vocabulary splits over (none where the mesh does
    not divide it: granite-moe's 49155 rows stay whole)."""
    return _dim_axes(mesh, rules, "vocab", vocab)


@dataclasses.dataclass(frozen=True)
class ServingCtx:
    """The serving layout in force: ``use_rules``' mesh and rules inside a
    ``use_tp_serving`` block."""
    mesh: Any
    rules: shd.Rules

    def plan(self, cfg) -> Optional[mtp.StageTPPlan]:
        return serving_plan(cfg, self.mesh, self.rules)

    def row_axes(self, batch: int) -> Tuple[str, ...]:
        return row_axes(self.mesh, self.rules, batch)

    def vocab_axes(self, cfg) -> Tuple[str, ...]:
        return vocab_axes(self.mesh, self.rules, cfg.vocab_size)

    def rows(self, batch: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a batch of ``batch``."""
        axes = self.row_axes(batch)
        return shd._cut(batch, self.mesh.size(axes), self.mesh.index(axes))

    def kv_heads(self, cfg) -> Tuple[int, int]:
        """(first, count) of the kv heads this rank's cache holds."""
        plan = self.plan(cfg)
        return local_kv_heads(cfg, plan,
                              self.mesh.index(plan.axes) if plan else 0)

    def cache_layout(self, cfg, batch: int) -> tuple:
        """What places a cache's pieces, the same on every rank: the axes
        its rows split over, and how its kv heads split (whole, or "shard"
        or "group" over the plan's axes; MLA's latent is whole)."""
        plan = self.plan(cfg)
        heads = (("whole",) if plan is None or cfg.attention_type == "mla"
                 or plan.kv_mode == mtp.KV_NONE else
                 (plan.kv_mode, plan.axes))
        return self.row_axes(batch), heads

    def scale_axes(self, cfg, batch: int) -> Tuple[str, ...]:
        """The axes a BP scale is reduced over: those of the batch rows
        and of the plan, in the mesh's order."""
        plan = self.plan(cfg)
        used = set(self.row_axes(batch)) | set(plan.axes if plan else ())
        return tuple(a for a in self.mesh.axis_names if a in used)


_ON = [False]       # process-wide, as dist.tp's plan: in a serving block


def current_serving() -> Optional[ServingCtx]:
    """The serving layout in force, or None outside any
    ``use_tp_serving``."""
    ctx = shd.current_ctx() if _ON[0] else None
    return None if ctx is None else ServingCtx(ctx.mesh, ctx.rules)


@contextlib.contextmanager
def use_tp_serving(mesh, phase: str, *, batch: int = 1):
    """Serve on ``mesh`` under ``phase``'s rules (at ``batch`` rows for
    "decode") while the block runs, on every rank of the mesh; nests,
    restoring the previous layout."""
    from repro_torch.dist import seq as _seq
    sizes = dict(mesh.shape)
    for axis in ("stage", "seq"):
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"tensor-parallel serving on a mesh with a {axis!r} axis "
                f"of {sizes[axis]} {RING_NEXT}")
    if _seq.current_ring() is not None:
        raise NotImplementedError(f"tensor-parallel serving under a ring "
                                  f"{RING_NEXT}")
    prev = _ON[0]
    with shd.use_rules(mesh, serving_rules(mesh, phase, batch)):
        _ON[0] = True
        try:
            yield current_serving()
        finally:
            _ON[0] = prev


def check(cfg, batch: Optional[int] = None) -> None:
    """Refuse what this slice does not serve under the installed layout
    (nothing outside one)."""
    ctx = current_serving()
    if ctx is None:
        return
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel serving takes the decoder family "
            f"only; the {cfg.family} family on a serving mesh "
            f"{FAMILIES_NEXT}")
    if cfg.matmul_mode in ("bp8", "bp8_lowrank") and (
            ctx.plan(cfg) is not None
            or (batch is not None and ctx.row_axes(batch))):
        raise NotImplementedError(
            f"{cfg.name}: matmul_mode {cfg.matmul_mode!r} takes its BP "
            f"scales per piece; on a serving mesh that splits a weight or "
            f"the batch it {SERVING_NEXT}")
    if cfg.num_experts and batch is not None and ctx.row_axes(batch):
        raise NotImplementedError(
            f"{cfg.name}: a mixture-of-experts layer routes over the whole "
            f"batch; serving it with the batch of {batch} split over "
            f"{ctx.row_axes(batch)} {SERVING_NEXT}")


@dataclasses.dataclass(frozen=True)
class Rows:
    """One entry point's call at ``batch`` rows: ``cut`` takes a
    batch-major tensor (or a dict of them) to this rank's rows, ``gather``
    joins every rank's rows of a result; both pass through outside a
    serving layout (``ctx`` None)."""
    ctx: Optional[ServingCtx]
    batch: int

    def cut(self, t):
        if isinstance(t, dict):
            return {k: self.cut(v) for k, v in t.items()}
        if self.ctx is None or not isinstance(t, torch.Tensor) \
                or t.dim() == 0:
            return t
        lo, hi = self.ctx.rows(self.batch)
        return t[lo:hi]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        axes = () if self.ctx is None else self.ctx.row_axes(self.batch)
        if not axes:
            return t
        return torch.cat(self.ctx.mesh.all_gather(t.contiguous(), axes), 0)


@contextlib.contextmanager
def call(model, batch: int, params, cache=None):
    """One of ``model``'s entry points at ``batch`` rows: under a serving
    layout, refuses what it does not serve, and params or a cache that
    are not this layout's pieces (``check_pieces``), then installs the
    plan and the scales' reduction.  Yields the call's :class:`Rows`."""
    ctx = current_serving()
    if ctx is None:
        yield Rows(None, batch)
        return
    cfg = model.cfg
    check(cfg, batch)
    check_pieces(model, ctx, params, cache, batch)
    plan = ctx.plan(cfg)
    with mtp.use_stage_tp(plan, ctx.mesh if plan else None, exact=True), \
            mtp.global_scales(ctx.mesh, ctx.scale_axes(cfg, batch)):
        yield Rows(ctx, batch)


# ---------------------------------------------------------------------------
# a rank's pieces
# ---------------------------------------------------------------------------

#: the layout each cache made on a serving mesh was made in, by its first
#: leaf (the entry points write a cache in place)
_MADE_IN = weak.WeakIdKeyDictionary()


def _first_leaf(cache) -> torch.Tensor:
    from repro_torch.models.params import tree_leaves
    return tree_leaves(cache)[0][1]


def mark_cache(cache, layout) -> None:
    """Record that ``cache`` holds its pieces under ``layout``
    (``ServingCtx.cache_layout``)."""
    _MADE_IN[_first_leaf(cache)] = layout


def check_pieces(model, ctx: ServingCtx, params, cache, batch: int) -> None:
    """Raise unless ``params`` are this rank's pieces under ``ctx``
    (``serve_params``' shapes, leaf by leaf) and ``cache`` (if any) holds
    this rank's rows and kv heads at ``batch`` rows: ValueError for a
    shape, NotImplementedError for a cache made under another layout of
    the same request (the "decode" rules' fold after a "prefill").  Every
    cut is even, so every rank decides alike."""
    from repro_torch.models.params import tree_leaves
    cfg = model.cfg
    want = dict(("/".join(k), v) for k, v in tree_leaves(
        local_shapes(model, ctx.mesh, ctx.rules)))
    got = {"/".join(k): tuple(v.shape) for k, v in tree_leaves(params)}
    if got != want:
        key = next(k for k in sorted(set(got) | set(want))
                   if got.get(k) != want.get(k))
        raise ValueError(
            f"{cfg.name}: param {key} is {got.get(key)} on this rank, not "
            f"{want.get(key)}: serve the pieces that serve_params(model, "
            f"params, mesh, rules) cuts under the rules in force")
    if cache is None:
        return
    layout = ctx.cache_layout(cfg, batch)
    made = _MADE_IN.get(_first_leaf(cache))
    if made is not None and made != layout:
        raise NotImplementedError(
            f"{cfg.name}: this cache holds its pieces under another layout "
            f"(rows over {made[0]}, kv heads {made[1]}) than this call's "
            f"(rows over {layout[0]}, kv heads {layout[1]}); handing a "
            f"cache over between two phases' layouts {SERVING_NEXT}: serve "
            f"the request under one phase's rules")
    length = next(iter(cache.values()))["pos"].shape[2]
    spec = model.cache_spec(batch, length)
    for stack, leaves in spec.items():
        for key, (shape, _) in leaves.items():
            have = tuple(cache[stack][key].shape)
            if have != tuple(shape):
                raise ValueError(
                    f"{cfg.name}: cache {stack}/{key} is {have} on this "
                    f"rank, not {tuple(shape)} of its rows and kv heads at "
                    f"a batch of {batch}: make it with init_cache (or "
                    f"prefill) under the rules in force")
    mark_cache(cache, layout)


def local_kv_heads(cfg, plan: Optional[mtp.StageTPPlan], index: int = 0
                   ) -> Tuple[int, int]:
    """(first, count) of the kv heads a rank at ``index`` over the plan's
    axes holds in its cache: ``kv_heads / tp`` of them in "shard" mode,
    the one its contiguous q-head block reads in "group" mode, all of
    them otherwise (and MLA's latent is whole)."""
    kh = cfg.num_kv_heads
    if plan is None or cfg.attention_type == "mla":
        return 0, kh
    if plan.kv_mode == mtp.KV_SHARD:
        n = kh // plan.size
        return index * n, n
    if plan.kv_mode == mtp.KV_GROUP:
        return mtp.group_kv_head(cfg, plan.size, index), 1
    return 0, kh


def serve_placements(model, mesh, rules) -> Any:
    """Placements of ``model``'s whole param tree on ``mesh`` under
    ``rules``: the layer stacks by the plan, the embedding and an untied
    head by "vocab", every other leaf whole."""
    from repro_torch.models.params import axes_tree, tree_map
    plan = serving_plan(model.cfg, mesh, rules)
    schema = model.schema()
    axes = axes_tree(schema)
    out = {}
    for key, sub in axes.items():
        if key in ("layers", "dense_layers"):
            out[key] = mtp.layer_placements(plan, sub, stage_axis=None)
        elif key in ("embed", "head"):
            out[key] = shd.partition_spec(mesh, rules, schema[key].shape,
                                          sub)
        else:
            out[key] = tree_map(lambda ax: (None,) * len(ax), sub)
    return out


def serve_params(model, params, mesh, rules) -> Any:
    """This rank's pieces (contiguous copies) of a whole param tree."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda t, p: shd.local_shard(t, p, mesh).clone(),
                    params, serve_placements(model, mesh, rules))


def local_shapes(model, mesh, rules) -> Any:
    """The shape of each of this rank's pieces of ``model``'s params under
    ``rules``: what ``serve_params`` gives."""
    from repro_torch.models.params import tree_map
    return tree_map(
        lambda d, p: tuple(shd.local_shard(
            torch.empty(d.shape, device="meta"), p, mesh).shape),
        model.schema(), serve_placements(model, mesh, rules))
