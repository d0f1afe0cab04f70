"""Sequence parallelism: ring attention over a "seq" mesh axis.

The reference's ``repro.dist.seq`` on the port's meshes of ranks.  The
attention core in ``repro_torch.models.attention`` knows how to ring
(``ring_sdpa`` / ``ring_mla``): given this rank's KV block, it fills
per-block online-softmax partials over point-to-point sends along the
ring and merges them in canonical order.  This module is the bridge
between that core and the model code:

  * ``use_ring(mesh)`` installs an ambient :class:`RingCtx` under which
    the attention layers offer their KV to the ring instead of calling
    plain ``sdpa``.
  * ``ring_attend`` / ``ring_attend_mla`` read the placements from the
    ambient sharding rules (``sharding.current_ctx()``) through the
    port's ``partition_spec``: the KV token dim gets whatever mesh axes
    the rules give "kv_seq" (or "seq" for cache-less attention), and that
    axis tuple *is* the ring.  They return None - the dense path runs -
    wherever the reference's return None: no contexts, a KV token dim the
    rules leave whole, a layout the schedules cannot serve.

There is no ``shard_map`` in eager torch, so these functions take each
rank's *local pieces*: q holds this rank's query rows (a block of them
while the model has sharded its rows over the ring, ``shard_rows``, else
all of them) and the rank's heads over its kv heads; k/v/kv_pos hold
this rank's KV block (``kv_local=True``: a block of a seq-sharded cache)
or the whole KV, which is padded (``pad_kv``) and cut here.

The schedule follows q's placement as the reference's does: q held in
blocks over the ring rotates the KV blocks ("kv"), q held whole on every
rank rotates the (m, l, acc) stats ("stats").  Both give the same bits.

The model side (``models/model.py``) decides the layouts with the same
rules: ``kv_ring`` (a cache's token dim over the ring, one block of
``ceil(L / n)`` slots a rank) and ``row_ring`` (a prompt's rows over the
ring, when the rules shard "seq" and n divides the length).

The context sits in a process-wide slot, not a thread-local one, as the
TP plan does (``dist/tp.py``): autograd and recomputation run on threads
of their own.  Nothing here touches a device or a process group at
import.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist import tp as mtp
from repro_torch.kernels import ops as _ops

#: what this slice leaves to the next (ROADMAP Queue 1 item 5c)
NEEDS_NEXT = "waits for ROADMAP Queue 1 item 5c"


@dataclasses.dataclass(frozen=True)
class RingCtx:
    """The ambient ring: the mesh, the name of its ring axis, and
    ``rows``, the whole length of the sequence whose rows this rank holds
    a block of, cut over ``row_axes`` (set by ``shard_rows`` while the
    model's rows are sharded over the ring; None when every rank holds
    every row)."""
    mesh: Any
    axis: str = "seq"
    rows: Optional[int] = None
    row_axes: Tuple[str, ...] = ()


_SLOT = [None]     # process-wide, as dist.tp's plan


def current_ring() -> Optional[RingCtx]:
    """The active :class:`RingCtx`, or None outside any ``use_ring``."""
    return _SLOT[0]


@contextlib.contextmanager
def _installed(ctx: Optional[RingCtx]):
    prev = _SLOT[0]
    _SLOT[0] = ctx
    try:
        yield ctx
    finally:
        _SLOT[0] = prev


def use_ring(mesh, axis: str = "seq"):
    """Install a ring over ``axis`` of ``mesh`` while the block runs
    (nests, restoring the previous one).  Whether a tensor rings is then
    decided per call from the ambient rules, so a ``use_ring`` around a
    model whose rules never shard "kv_seq" is a no-op, not an error."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh {tuple(mesh.shape.items())} has no "
                         f"{axis!r} axis")
    return _installed(RingCtx(mesh, axis))


@contextlib.contextmanager
def shard_rows(total: int, layout: "RingLayout"):
    """Mark the block as running on this rank's block of ``total`` rows
    cut over ``layout`` (``row_ring``'s: the model's prefill over sharded
    rows): the attention layers take their queries as a block, and every
    BP scale is reduced (MAX) over the ring before its kernel, so that it
    covers the whole sequence as the reference's partitioner's does."""
    ctx = current_ring()
    with _installed(dataclasses.replace(ctx, rows=total,
                                        row_axes=layout.axes)), \
            mtp.global_scales(ctx.mesh, layout.axes):
        yield


@contextlib.contextmanager
def whole_rows():
    """Inside ``shard_rows``, run the block on the whole sequence's rows
    (``gather_rows``'): no row block, and no scale reduction, since every
    rank holds the same rows and its scales are already the whole
    sequence's."""
    ctx = current_ring()
    with _installed(dataclasses.replace(ctx, rows=None, row_axes=())), \
            _ops.reduced_scales(None):
        yield


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's block of rows (dim 1) under ``shard_rows``, joined in
    ring order: the whole sequence's."""
    ctx = current_ring()
    return torch.cat(ctx.mesh.all_gather(x.contiguous(), ctx.row_axes), 1)


def row_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole sequence's rows (dim 1) under
    ``shard_rows``."""
    ctx = current_ring()
    c = ctx.rows // ctx.mesh.size(ctx.row_axes)
    lo = ctx.mesh.index(ctx.row_axes) * c
    return x[:, lo:lo + c]


def on_one_rank(fn, shape, dtype, device, owner: int = 0) -> torch.Tensor:
    """``fn()`` (a tensor of ``shape`` and ``dtype``), computed on the
    ring's rank ``owner`` alone and given to every rank of the ring: what
    every rank would compute alike (the logits of rows they all hold, or
    of the last row, which the last rank holds) is computed once."""
    ctx = current_ring()
    mine = (fn() if ctx.mesh.index(ctx.axis) == owner else
            torch.zeros(shape, dtype=dtype, device=device))
    return ctx.mesh.all_gather(mine.contiguous(), ctx.axis)[owner]


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    """One placement entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _strip(entry, banned):
    """Drop ``banned`` axes from a placement entry (ring axes may only
    ever shard the KV token dim)."""
    kept = tuple(a for a in _axes(entry) if a not in banned)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def pad_kv(k, v, kv_pos, total: int):
    """Pad (k, v, kv_pos) along the token dim (dim 1) to ``total`` slots.
    Padded slots carry position -1, the empty-slot sentinel, so the mask
    drops them and a fully padded block is wiped exactly by the merge."""
    pad = total - k.shape[1]
    if pad <= 0:
        return k, v, kv_pos

    def widen(t, value=0):
        widths = [0, 0] * (t.dim() - 2) + [0, pad]
        return torch.nn.functional.pad(t, widths, value=value)

    return widen(k), widen(v), widen(kv_pos, -1)


def _ring_axes_for(mesh, rules, kv_shape, kv_axes, ring_axis,
                   local: bool = False):
    """The (placement, ring_axes, n) the rules give a KV tensor, or None
    when its token dim ends up whole or off the declared ring axis.

    The token dim (dim 1) is probed rounded UP to the candidate ring size,
    as the reference's: divisibility must not veto the ring, only shape
    the padding.  ``local``: ``kv_shape[1]`` is one rank's block, and the
    probe takes the candidate ring's blocks together."""
    if not isinstance(rules, shd.Rules):
        rules = shd.Rules(rules)
    cand = math.prod(mesh.shape[a] for a in rules.mesh_axes(kv_axes[1])
                     if a in mesh.shape)
    probe = list(kv_shape)
    if cand > 1:
        probe[1] = probe[1] * cand if local else -(-probe[1] // cand) * cand
    kspec = shd.partition_spec(mesh, rules, tuple(probe), kv_axes)
    ring_axes = _axes(kspec[1])
    if not ring_axes or ring_axis not in ring_axes:
        return None
    n = math.prod(mesh.shape[a] for a in ring_axes)
    if n <= 1:
        return None
    return kspec, ring_axes, n


@dataclasses.dataclass(frozen=True)
class RingLayout:
    """Where a dim sits on the ring: over ``axes`` (``n`` ranks), this
    rank at ``index``."""
    axes: Tuple[str, ...]
    n: int
    index: int

    def block(self, length: int) -> Tuple[int, int]:
        """(first, size) of this rank's block of ``length`` items cut in
        ``n`` blocks of ``ceil(length / n)``."""
        c = -(-length // self.n)
        return self.index * c, c


def _layout(mesh, ring_axes, n) -> RingLayout:
    return RingLayout(ring_axes, n, mesh.index(ring_axes))


def kv_ring(batch: int) -> Optional[RingLayout]:
    """The layout of a KV cache's token dim ("kv_seq") under the ambient
    ring and rules, or None when it stays whole on every rank.  A rank
    then holds one block of ``ceil(L / n)`` slots of a cache of L."""
    ctx, sctx = current_ring(), shd.current_ctx()
    if ctx is None or sctx is None:
        return None
    got = _ring_axes_for(ctx.mesh, sctx.rules, (batch, 1),
                         ("batch", "kv_seq"), ctx.axis, local=True)
    return None if got is None else _layout(ctx.mesh, got[1], got[2])


def row_ring(batch: int, length: int) -> Optional[RingLayout]:
    """The layout of a prefill's (batch, length) rows when the ambient
    rules shard "seq" over exactly the ring of its cache's KV: the
    reference's query placement, divisibility fallback included (n must
    divide ``length``); None when every rank holds every row."""
    ctx, sctx = current_ring(), shd.current_ctx()
    if ctx is None or sctx is None:
        return None
    got = _ring_axes_for(ctx.mesh, sctx.rules, (batch, length),
                         ("batch", "kv_seq"), ctx.axis)
    if got is None:
        return None
    spec = shd.partition_spec(ctx.mesh, sctx.rules, (batch, length),
                              ("batch", "seq"))
    if _axes(spec[1]) != got[1]:
        return None
    return _layout(ctx.mesh, got[1], got[2])


def check_serving(cfg) -> None:
    """Refuse what this slice does not serve under a ring: the families
    other than the decoders, and a "model" axis (the port has no
    serving-side tensor parallelism yet)."""
    ctx = current_ring()
    if ctx is None:
        return
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: sequence parallelism serves the decoder family "
            f"only; the {cfg.family} family under a ring {NEEDS_NEXT}")
    if ctx.mesh.size("model") > 1:
        raise NotImplementedError(
            f"{cfg.name}: serving under a ring with a 'model' axis of "
            f"{ctx.mesh.size('model')} (tensor-parallel serving) "
            f"{NEEDS_NEXT}")


def _check_inference(*ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(f"the ring under training (gradients "
                                  f"through its sends) {NEEDS_NEXT}")


# ---------------------------------------------------------------------------
# GQA ring entry point
# ---------------------------------------------------------------------------

def ring_attend(q, k, v, q_pos, kv_pos, *, kv_logical="kv_seq",
                kv_local=False, causal=True, window=None, prefix_len=None,
                softcap=None):
    """Ring-attend ``q`` over a KV whose token dim the ambient rules
    shard; returns this rank's (B,Sq_loc,H_loc,Dv) output, or None when
    the ring does not apply (the caller then runs ``sdpa``).

    Local pieces: q (B,Sq_loc,H_loc,D) and q_pos (B,Sq_loc), this rank's
    rows (a block of ``RingCtx.rows`` under ``shard_rows``, else all of
    them); k/v (B,c,KH_loc,D[v]) and kv_pos (B,c), this rank's KV block
    when ``kv_local``, else the whole KV (B,Skv,...), padded with
    ``pad_kv`` and cut here.  ``prefix_len`` (B,) is whole."""
    ctx, sctx = current_ring(), shd.current_ctx()
    if ctx is None or sctx is None:
        return None
    _check_inference(q, k, v)
    mesh, rules = ctx.mesh, sctx.rules
    got = _ring_axes_for(mesh, rules, k.shape, ("batch", kv_logical,
                                                "kv_heads", None),
                         ctx.axis, local=kv_local)
    if got is None:
        return None
    kspec, ring_axes, n = got
    b, sq_loc, h, d = q.shape
    sq = ctx.rows if ctx.rows is not None else sq_loc
    qspec0 = shd.partition_spec(mesh, rules, (b, sq, h, d),
                                ("batch", "seq", "heads", None))
    q_seq = _axes(qspec0[1])
    if any(a in ring_axes for a in q_seq):
        if q_seq != ring_axes:
            return None             # q sharded over a mismatched ring
        q_seq_entry = qspec0[1]
    else:
        q_seq_entry = _strip(qspec0[1], set(ring_axes))
    if ctx.rows is not None and q_seq_entry is None:
        raise RuntimeError(f"rows sharded over the ring, but the rules "
                           f"keep a query of {sq} rows whole")
    # q whole on this rank rotates the stats; a block of q rotates the KV
    rotate = "kv" if ctx.rows is not None else "stats"
    kvh = _strip(kspec[2], set(ring_axes))
    if any(a in _axes(kvh) for a in _axes(q_seq_entry)):
        return None
    if not kv_local:
        layout = _layout(mesh, ring_axes, n)
        skv = k.shape[1]
        k, v, kv_pos = pad_kv(k, v, kv_pos, skv + (-skv) % n)
        lo, c = layout.block(k.shape[1])
        k, v, kv_pos = k[:, lo:lo + c], v[:, lo:lo + c], kv_pos[:, lo:lo + c]
    from repro_torch.models import attention as A
    return A.ring_sdpa(q, k, v, q_pos, kv_pos, mesh=mesh, axes=ring_axes,
                       n_blocks=n, rotate=rotate, causal=causal,
                       window=window, prefix_len=prefix_len, softcap=softcap)


# ---------------------------------------------------------------------------
# absorbed-MLA ring entry point
# ---------------------------------------------------------------------------

def ring_attend_mla(qa, q_rope, ckv, krope, q_pos, kv_pos, *, window=None,
                    scale):
    """Ring the absorbed-MLA decode over a seq-sharded latent cache.
    Local pieces: qa (B,Sq,H,R) (W_uk absorbed) and q_rope (B,Sq,H,P),
    whole on every rank of the ring; ckv (B,c,R), krope (B,c,P), kv_pos
    (B,c), this rank's block of the latent cache.  Returns o_lat
    (B,Sq,H,R) or None when the ring does not apply."""
    ctx, sctx = current_ring(), shd.current_ctx()
    if ctx is None or sctx is None:
        return None
    _check_inference(qa, q_rope, ckv)
    if ctx.rows is not None:
        raise ValueError("the absorbed-MLA ring rotates the stats: its "
                         "queries must be whole on every rank")
    mesh, rules = ctx.mesh, sctx.rules
    got = _ring_axes_for(mesh, rules, ckv.shape, ("batch", "kv_seq", None),
                         ctx.axis, local=True)
    if got is None:
        return None
    _, ring_axes, n = got
    qspec0 = shd.partition_spec(mesh, rules, qa.shape,
                                ("batch", "seq", "heads", None))
    banned = set(ring_axes)
    heads = _strip(qspec0[2], banned)
    q_seq = _strip(qspec0[1], banned)
    if any(a in _axes(heads) for a in _axes(q_seq)):
        return None
    from repro_torch.models import attention as A
    return A.ring_mla(qa, q_rope, ckv, krope, q_pos, kv_pos, mesh=mesh,
                      axes=ring_axes, n_blocks=n, rotate="stats",
                      window=window, scale=scale)
