"""Sharding rules: logical axis names -> mesh axes, as per-leaf placements.

The reference's ``repro.dist.sharding`` on the port's meshes.  Every
tensor is annotated with *logical* axis names ("batch", "ffn", "heads",
... ``models/params.py``'s vocabulary); a ``Rules`` mapping decides which
*mesh* axes those names shard over.  ``partition_spec`` resolves one
(shape, axes) pair to a *placement*: one entry per dim, None (whole), a
mesh axis, or a tuple of mesh axes applied jointly (the entries of the
reference's ``PartitionSpec``), under the reference's three fallbacks:

  1. *mesh presence*: mesh axes absent from the mesh are dropped;
  2. *divisibility*: a mesh axis splits only a dim it divides (checked
     cumulatively when several stack on one dim);
  3. *each mesh axis at most once*: an axis used by an earlier dim is
     skipped.

``local_shard(tensor, placement, mesh)`` cuts the piece of a whole leaf
that this rank holds, and ``gather`` puts the pieces back together.  A
split dim is cut into contiguous pieces of ``ceil(n / ranks)`` (the last
may be shorter: a layer stack that the stage count does not divide, as
the reference's ``stack_stages_padded`` pads it).

There is no partitioner in eager torch: ``shard(x, *axes)`` is a checked
no-op under ``use_rules`` (it raises if the rules split a dim the mesh
does not divide), and the model code that runs on local pieces
(``dist/tp.py``) says so itself.  Presets: ``get_rules(phase, **opts)``
over a ``register_rules`` registry ("train", "prefill", "decode",
"pipeline", "dp_only", "sequence", and "sp"), with the reference's
deprecated free functions and ``RULE_PRESETS``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import warnings
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

#: A rule value: one mesh axis, or a tuple of mesh axes applied jointly to
#: one logical dimension (e.g. ("pod", "data") for the global batch).
MeshAxes = Union[str, Tuple[str, ...]]
#: A placement entry: None (whole), a mesh axis, or a tuple of them.
Placement = Tuple[Optional[MeshAxes], ...]


class Rules(Dict[str, MeshAxes]):
    """Mapping from logical axis names to mesh axes (a plain dict, so
    presets stay literal).  Names absent or mapped to None replicate."""

    def mesh_axes(self, name: Optional[str]) -> Tuple[str, ...]:
        """The tuple of mesh axes for logical ``name`` (empty = whole)."""
        if name is None:
            return ()
        want = self.get(name)
        if want is None:
            return ()
        return (want,) if isinstance(want, str) else tuple(want)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def _sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# placement resolution
# ---------------------------------------------------------------------------

def partition_spec(mesh, rules: Mapping[str, MeshAxes],
                   shape: Sequence[int],
                   axes: Sequence[Optional[str]]) -> Placement:
    """Resolve logical ``axes`` of a tensor of ``shape`` to a placement
    under the three fallbacks of the module docstring.  ``mesh`` is
    anything with a ``shape`` mapping of axis sizes."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    if not isinstance(rules, Rules):
        rules = Rules(rules)
    sizes = _sizes(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        picked = []
        remaining = int(dim)
        for ax in rules.mesh_axes(name):
            if ax not in sizes or ax in used:
                continue
            if remaining % sizes[ax]:
                continue  # divisibility fallback: toward replication
            picked.append(ax)
            used.add(ax)
            remaining //= sizes[ax]
        if not picked:
            entries.append(None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    return tuple(entries)


def named_sharding(mesh, rules: Mapping[str, MeshAxes],
                   shape: Sequence[int],
                   axes: Sequence[Optional[str]]) -> Placement:
    """The placement of one tensor on ``mesh`` (the reference's
    ``NamedSharding`` is its spec on its mesh)."""
    return partition_spec(mesh, rules, shape, axes)


def tree_shardings(mesh, rules: Mapping[str, MeshAxes], abstract: Any,
                   axes: Any) -> Any:
    """Placements for a tree of shapes: ``abstract``'s leaves are shapes
    (tuples) or anything with ``.shape``; ``axes`` the parallel tree of
    logical names (a scalar pairs with the empty tuple)."""
    return _tree_map(
        lambda a, ax: partition_spec(
            mesh, rules, tuple(a) if isinstance(a, tuple) else
            tuple(a.shape), tuple(ax)), abstract, axes)


def _entry_axes(entry: Optional[MeshAxes]) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _cut(n: int, pieces: int, i: int) -> Tuple[int, int]:
    per = -(-n // pieces)
    lo = min(n, i * per)
    return lo, min(n, lo + per)


def local_shard(tensor: torch.Tensor, placement: Placement,
                mesh) -> torch.Tensor:
    """The piece of a whole leaf that this rank holds (a view; each split
    dim cut into contiguous pieces of ceil(n / ranks))."""
    if len(placement) != tensor.dim():
        raise ValueError(f"placement {placement} for a {tensor.dim()}-D "
                         "leaf")
    out = tensor
    for d, entry in enumerate(placement):
        axes = _entry_axes(entry)
        if axes:
            lo, hi = _cut(tensor.shape[d], mesh.size(axes), mesh.index(axes))
            out = out.narrow(d, lo, hi - lo)
    return out


def gather(piece: torch.Tensor, placement: Placement, mesh,
           shape: Sequence[int], *, to_lead: bool = False
           ) -> Optional[torch.Tensor]:
    """The whole leaf of ``shape`` from every rank's ``piece``: the
    inverse of ``local_shard``.  Every rank gets it, or with ``to_lead``
    only the ranks at index 0 along the split axes (on the host under
    gloo; None elsewhere): what a checkpoint's writer needs, each piece
    sent once."""
    out = piece
    for d in reversed(range(len(placement))):
        axes = _entry_axes(placement[d])
        if not axes:
            continue
        n, k = int(shape[d]), mesh.size(axes)
        per = -(-n // k)
        pad = per - out.shape[d]
        if pad:
            widths = [0, 0] * (out.dim() - d - 1) + [0, pad]
            out = torch.nn.functional.pad(out, widths)
        if to_lead:
            parts = mesh.gather(out.contiguous(), axes)
            if parts is None:
                return None
        else:
            parts = mesh.all_gather(out.contiguous(), axes)
        out = torch.cat(parts, dim=d).narrow(d, 0, n)
    return out


# ---------------------------------------------------------------------------
# ambient rules context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The ambient (mesh, rules) pair installed by ``use_rules``."""
    mesh: Any
    rules: Rules


_LOCAL = threading.local()


def current_ctx() -> Optional[ShardCtx]:
    """The active ``ShardCtx``, or None outside any ``use_rules`` block."""
    return getattr(_LOCAL, "ctx", None)


@contextlib.contextmanager
def use_rules(mesh, rules: Mapping[str, MeshAxes]):
    """Install (mesh, rules) as the ambient context for ``shard``; nests,
    restoring the previous one on exit (thread-local)."""
    prev = current_ctx()
    _LOCAL.ctx = ShardCtx(mesh, Rules(rules))
    try:
        yield _LOCAL.ctx
    finally:
        _LOCAL.ctx = prev


@contextlib.contextmanager
def suppress_rules():
    """Clear the ambient context for a region that runs on local pieces
    (the pipeline's stage bodies), restoring it on exit."""
    prev = current_ctx()
    _LOCAL.ctx = None
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def shard(x: torch.Tensor, *axes: Optional[str],
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The reference's in-graph constraint, as a checked no-op: returns
    ``x``; under a context it raises if a rule names a mesh axis of the
    mesh that does not divide the dim it would split (the partitioner
    would fall back to replicating it silently)."""
    ctx = ctx or current_ctx()
    if ctx is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"shard: {len(axes)} names for a {x.dim()}-D "
                         "tensor")
    sizes = _sizes(ctx.mesh)
    for dim, name in zip(x.shape, axes):
        n = math.prod(sizes[a] for a in ctx.rules.mesh_axes(name)
                      if a in sizes)
        if dim % n:
            raise ValueError(f"shard: dim {dim} ({name!r}) is not "
                             f"divisible by the {n} ranks the rules split "
                             "it over")
    return x


# ---------------------------------------------------------------------------
# production presets: one registry, one entry point
# ---------------------------------------------------------------------------

_RULES_REGISTRY: Dict[str, Callable[..., Rules]] = {}


def register_rules(phase: str, fn: Optional[Callable[..., Rules]] = None):
    """Register a ``Rules`` factory under ``phase`` (decorator or direct
    call); a phase registered again is replaced."""
    def deco(f: Callable[..., Rules]) -> Callable[..., Rules]:
        _RULES_REGISTRY[phase] = f
        return f
    return deco if fn is None else deco(fn)


def rule_phases() -> Tuple[str, ...]:
    """All registered phase names, sorted."""
    return tuple(sorted(_RULES_REGISTRY))


def get_rules(phase: str, **opts) -> Rules:
    """The production layout of ``phase`` (a fresh dict); ``opts`` go to
    the preset (only "decode" takes any: ``batch`` and ``data_size``)."""
    try:
        fn = _RULES_REGISTRY[phase]
    except KeyError:
        raise ValueError(
            f"unknown parallelism phase {phase!r}; registered phases: "
            f"{list(rule_phases())}") from None
    return fn(**opts)


@register_rules("train")
def _train_rules_impl() -> Rules:
    """FSDP + tensor-parallel training: batch over ("pod", "data"); the
    contraction-orthogonal weight dims over "model"; "d_model" over
    "data" (ZeRO); activations' "seq" over "model"."""
    return Rules({
        "batch": ("pod", "data"),
        "seq": "model",
        "d_model": "data",
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "experts": "model",
    })


@register_rules("prefill")
def _prefill_rules_impl() -> Rules:
    """Inference prefill: tensor-parallel weights, data-parallel batch,
    no ZeRO."""
    return Rules({
        "batch": ("pod", "data"),
        "seq": "model",
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
    })


@register_rules("decode")
def _decode_rules_impl(batch: int = 1, data_size: int = 1) -> Rules:
    """Decode: like prefill when the batch tiles the data axis, else the
    data axis folds into model parallelism and the batch replicates."""
    if data_size <= 1 or (batch >= data_size and batch % data_size == 0):
        return Rules({
            "batch": ("pod", "data"),
            "ffn": "model",
            "heads": "model",
            "kv_heads": "model",
            "vocab": "model",
        })
    return Rules({
        "ffn": ("data", "model"),
        "heads": ("data", "model"),
        "kv_heads": ("data", "model"),
        "vocab": ("data", "model"),
    })


@register_rules("pipeline")
def _pipeline_rules_impl() -> Rules:
    """Pipelined training on a ("stage", "data", "model") mesh: the train
    layout plus the layer stack ("stack") over "stage"."""
    rules = _train_rules_impl()
    rules["stack"] = "stage"
    return rules


@register_rules("dp_only")
def _dp_only_rules_impl() -> Rules:
    """Pure data parallelism: every mesh axis acts as batch."""
    return Rules({"batch": ("pod", "data", "model")})


@register_rules("sequence")
def _sequence_rules_impl() -> Rules:
    """Long-context sequence parallelism on a ("seq", "data", "model")
    mesh: the KV cache's tokens over "seq", weights folded over every
    axis the batch leaves free."""
    return Rules({
        "batch": ("pod", "data"),
        "kv_seq": "seq",
        "seq": "seq",
        "ffn": ("seq", "data", "model"),
        "heads": ("seq", "data", "model"),
        "kv_heads": "model",
        "vocab": ("seq", "data", "model"),
        "experts": ("seq", "data", "model"),
    })


# --- deprecated free-function aliases (the reference's) --------------------
register_rules("sp", _train_rules_impl)


def _deprecated_alias(name: str, phase: str) -> None:
    warnings.warn(
        f"repro_torch.dist.sharding.{name}() is deprecated; use "
        f"get_rules({phase!r}) instead", DeprecationWarning, stacklevel=3)


def train_rules() -> Rules:
    """Deprecated alias for ``get_rules("train")``."""
    _deprecated_alias("train_rules", "train")
    return get_rules("train")


def prefill_rules() -> Rules:
    """Deprecated alias for ``get_rules("prefill")``."""
    _deprecated_alias("prefill_rules", "prefill")
    return get_rules("prefill")


def decode_rules(batch: int, data_size: int) -> Rules:
    """Deprecated alias for ``get_rules("decode", batch=, data_size=)``."""
    _deprecated_alias("decode_rules", "decode")
    return get_rules("decode", batch=batch, data_size=data_size)


def pipeline_rules() -> Rules:
    """Deprecated alias for ``get_rules("pipeline")``."""
    _deprecated_alias("pipeline_rules", "pipeline")
    return get_rules("pipeline")


def dp_only_rules() -> Rules:
    """Deprecated alias for ``get_rules("dp_only")``."""
    _deprecated_alias("dp_only_rules", "dp_only")
    return get_rules("dp_only")


#: Zero-arg callable view of the presets (the reference's dry-run list).
RULE_PRESETS = {
    "train": train_rules,
    "prefill": prefill_rules,
    "dp_only": dp_only_rules,
    "sp": train_rules,
    "pipeline": pipeline_rules,
}
