"""Attention: GQA with KV caches, plain or BP8-quantised, and MLA
(multi-head latent attention) over a bf16 latent cache.

``sdpa`` is the reference's masked-softmax attention written in torch
einsum/softmax (direct, or an online softmax over KV chunks when the
cache is long), not ``F.scaled_dot_product_attention``.  Caches carry a
per-slot position array; ``pos < 0`` marks an empty slot.

Caches are updated in place (``_cache_write`` / ``_cache_append`` write
into the tensors they are given and return the same dict): the paged
engine hands each step a freshly gathered view, so nothing else sees
the writes, and no second copy of the cache is made per layer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import device_constant
from repro_torch.dist import seq as _seq
from repro_torch.dist import tp as _tp
from repro_torch.kernels import attention as kq
from repro_torch.models.layers import (ParamDef, apply_rope, dense,
                                       linear_def, norm_def, rms_norm)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mask + softmax core
# ---------------------------------------------------------------------------

def _allowed(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
             window: Optional[int],
             prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Sq, Skv) boolean mask from absolute positions (kv_pos < 0 =
    empty slot).  ``prefix_len`` (B,): keys below it are visible to every
    query (the prefix-LM's bidirectional prefix)."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    ok = kp >= 0
    if causal:
        c = kp <= qp
        if prefix_len is not None:
            c = c | (kp < prefix_len[:, None, None])
        ok = ok & c
    if window is not None:
        ok = ok & (qp - kp < window)
    return ok


@device_constant
def _neg_inf(dtype, device) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=dtype, device=device)


@device_constant
def _sdpa_scale(d: int, device) -> torch.Tensor:
    """1 / sqrt(d), computed on the CPU and moved to ``device``."""
    return (1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))).to(device)


@device_constant
def _sqrt_d(d: int, device) -> torch.Tensor:
    """sqrt(d) on ``device``: decode divides q by it (a division, which
    the multiply by a reciprocal would not give bit for bit)."""
    return torch.sqrt(torch.tensor(d, dtype=torch.float32, device=device))


def _masked(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, scores, _neg_inf(scores.dtype, scores.device))


def _sdpa_direct(q, k, v, mask, softcap=None):
    """q: (B,KH,G,Sq,D) k: (B,KH,Skv,D) v: (B,KH,Skv,Dv) mask: (B,Sq,Skv)."""
    scores = torch.einsum("bhgqd,bhsd->bhgqs", q.to(torch.float32),
                          k.to(torch.float32))
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    p = torch.softmax(_masked(scores, mask[:, None, None]), dim=-1)
    return torch.einsum("bhgqs,bhsv->bhgqv", p, v.to(torch.float32))


def _sdpa_chunked(q, k, v, q_pos, kv_pos, *, causal, window, chunk,
                  softcap=None, prefix_len=None):
    """Online softmax over KV chunks; never forms (Sq, Skv) in full."""
    b, kh, g, sq, _ = q.shape
    dv = v.shape[-1]
    qf = q.to(torch.float32)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, k.shape[2], chunk):
        kc = k[:, :, c0:c0 + chunk].to(torch.float32)
        vc = v[:, :, c0:c0 + chunk].to(torch.float32)
        s = torch.einsum("bhgqd,bhsd->bhgqs", qf, kc)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = _allowed(q_pos, kv_pos[:, c0:c0 + chunk], causal=causal,
                        window=window, prefix_len=prefix_len)
        s = _masked(s, mask[:, None, None])
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqs,bhsv->bhgqv", p,
                                                    vc)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def sdpa(q, k, v, q_pos, kv_pos, *, causal=True, window=None, chunk=1024,
         softcap=None, prefix_len=None):
    """Grouped SDPA. q: (B,Sq,H,D) k/v: (B,Skv,KH,D[v]) -> (B,Sq,H,Dv) f32."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    qg = qg.to(torch.float32) * _sdpa_scale(d, q.device)
    if skv > chunk and skv % chunk == 0:
        out = _sdpa_chunked(qg, kt, vt, q_pos, kv_pos, causal=causal,
                            window=window, chunk=chunk, softcap=softcap,
                            prefix_len=prefix_len)
    else:
        mask = _allowed(q_pos, kv_pos, causal=causal, window=window,
                        prefix_len=prefix_len)
        out = _sdpa_direct(qg, kt, vt, mask, softcap=softcap)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1)


# ---------------------------------------------------------------------------
# ring attention (sequence parallelism over a "seq" mesh axis)
#
# The KV sequence lives cut over a ring of ranks, one contiguous block a
# rank.  Attention over the whole sequence is recovered from per-block
# online-softmax partials (m, l, acc) merged in canonical block order, so
# the result has the same bits whichever rank computed which block.  Two
# schedules give the same partials:
#
#   * rotate="kv"    - the queries stay put (sharded or whole); the KV
#                      blocks travel the ring (n - 1 hops).  Prefill's.
#   * rotate="stats" - each rank computes its own block's partial once and
#                      the (m, l, acc) tuple travels instead: for decode
#                      (Sq == 1) O(heads * head_dim) bytes a hop.
#
# Causal masks, windows, prefixes and empty slots all come from the
# absolute-position mask: a fully masked block gives m = NEG_INF and is
# wiped exactly (exp(NEG_INF - m) == 0) by the merge.
#
# A block's partial is computed in pieces of at most ``_ring_rows`` query
# rows (each row's partial is independent of the others'), never in
# pieces of keys (that would change the order of the sums): a whole
# block's scores at qwen2-72b's heads and 8192-token blocks would be
# 17 GB.  The oracles (``ring_reference``, ``ring_mla_reference``) cut
# the queries the same way, so that every einsum and reduction of the
# ring has its twin of the same shape there, and ring == oracle bit for
# bit.  ``repro_torch.dist.seq`` wraps these functions for the model.
# ---------------------------------------------------------------------------

#: the elements of one piece's (..., rows, block) score tensor: 0.5 GiB
#: in f32, so a piece's transients (scores, probabilities, mask) stay
#: under 2 GB
RING_PIECE_ELEMENTS = 1 << 27


def _ring_rows(per_row: int, rows: int) -> int:
    """Query rows a piece takes when one row's scores are ``per_row``
    elements."""
    return max(1, min(rows, RING_PIECE_ELEMENTS // max(per_row, 1)))


def _block_partials(qg, kb, vb, q_pos, kp_b, *, causal, window, prefix_len,
                    softcap):
    """Online-softmax partial of one KV block.

    qg: (B,KH,G,Sq,D) pre-scaled f32 queries; kb: (B,KH,c,D); vb:
    (B,KH,c,Dv); kp_b: (B,c) absolute positions (-1 = empty slot).
    Returns (m, l, acc): (B,KH,G,Sq), (B,KH,G,Sq), (B,KH,G,Sq,Dv).  The
    queries go in pieces of ``_ring_rows`` rows; every operand is made
    contiguous, so that equal shapes take equal kernels."""
    b, kh, g, sq, _ = qg.shape
    c = kb.shape[2]
    kb = kb.to(torch.float32).contiguous()
    vb = vb.to(torch.float32).contiguous()
    rows = _ring_rows(kh * g * c * b, sq)
    ms, ls, accs = [], [], []
    for r0 in range(0, sq, rows):
        qc = qg[:, :, :, r0:r0 + rows].contiguous()
        s = torch.einsum("bhgqd,bhsd->bhgqs", qc, kb)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = _allowed(q_pos[:, r0:r0 + rows], kp_b, causal=causal,
                        window=window, prefix_len=prefix_len)
        s = _masked(s, mask[:, None, None])
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgqs,bhsv->bhgqv", p, vb))
    return (torch.cat(ms, 3), torch.cat(ls, 3), torch.cat(accs, 3))


def merge_block_partials(ms, ls, accs):
    """Merge per-block partials stacked on dim 0 in canonical block order
    (a left-to-right loop, the reference's float expressions); returns
    acc / l, the attention output."""
    m, l, acc = ms[0], ls[0], accs[0]
    for j in range(1, ms.shape[0]):
        mj, lj, accj = ms[j], ls[j], accs[j]
        mn = torch.maximum(m, mj)
        a, bcoef = torch.exp(m - mn), torch.exp(mj - mn)
        l = l * a + lj * bcoef
        acc = acc * a[..., None] + accj * bcoef[..., None]
        m = mn
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def _ring_rotate(mesh, axes, tensors):
    """Each tensor sent one step along the ring ``axes`` and the previous
    rank's received in its place: one message per dtype (the tensors of a
    dtype travel packed)."""
    out = list(tensors)
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        got = mesh.shift(flat, axes)
        o = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = got[o:o + n].view(tensors[i].shape)
            o += n
    return tuple(out)


def _ring_run(mesh, axes, n, rotate, local_partial, kv_operands,
              part_shapes, device):
    """The ring loop of both schedules: fill (ms, ls, accs) buffers
    indexed by global block id, then merge them canonically.
    ``local_partial(ops)`` gives (m, l, acc) for the KV operand tuple
    ``ops``; ``kv_operands`` is this rank's own block."""
    idx = mesh.index(axes)
    bufs = [torch.zeros(s, dtype=torch.float32, device=device)
            for s in part_shapes]

    def put(j, part):
        for buf, p in zip(bufs, part):
            buf[j] = p

    if rotate == "kv":
        cur = kv_operands
        for t in range(n):
            put((idx - t) % n, local_partial(cur))
            if t + 1 < n:
                cur = _ring_rotate(mesh, axes, cur)
    elif rotate == "stats":
        cur = local_partial(kv_operands)
        for t in range(n):
            put((idx - t) % n, cur)
            if t + 1 < n:
                cur = _ring_rotate(mesh, axes, cur)
    else:
        raise ValueError(f"unknown ring schedule {rotate!r}")
    return merge_block_partials(*bufs)


def _grouped_queries(q, kh: int):
    """(B,Sq,H,D) -> (B,KH,G,Sq,D) f32, divided by sqrt(D) (the
    reference's ring divides where ``sdpa`` multiplies)."""
    b, sq, h, d = q.shape
    qg = q.reshape(b, sq, kh, h // kh, d).permute(0, 2, 3, 1, 4)
    return qg.to(torch.float32) / _sqrt_d(d, q.device)


def ring_sdpa(q, k, v, q_pos, kv_pos, *, mesh, axes, n_blocks, rotate="kv",
              causal=True, window=None, prefix_len=None, softcap=None):
    """Grouped SDPA over a KV sequence cut over the ring ``axes`` of
    ``mesh`` (``n_blocks`` ranks), on this rank's pieces: q
    (B,Sq_loc,H_loc,D), k/v (B,c,KH_loc,D[v]) (its block), q_pos
    (B,Sq_loc), kv_pos (B,c).  Under "stats" every rank of the ring holds
    the same queries; under "kv" each may hold its own block of them.
    Both schedules return the same bits."""
    b, sq, h, _ = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = _grouped_queries(q, kh)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    dv = vt.shape[-1]

    def local_partial(ops):
        kb, vb, kp = ops
        return _block_partials(qg, kb, vb, q_pos, kp, causal=causal,
                               window=window, prefix_len=prefix_len,
                               softcap=softcap)

    shp = (n_blocks, b, kh, g, sq)
    out = _ring_run(mesh, axes, n_blocks, rotate, local_partial,
                    (kt, vt, kv_pos), (shp, shp, shp + (dv,)), q.device)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1)


def _oracle_merge(part, n_blocks: int, q_blocks: int, sq: int, dim: int):
    """The oracles' merged output: the queries cut into ``q_blocks``
    contiguous blocks, each computed and merged as the rank holding it
    computes and merges it (``part(j, lo, hi)``: KV block j's partial of
    rows [lo, hi)), joined along the query dim ``dim``.  Equal shapes
    matter on the CPU too: an elementwise op's tail elements take a
    scalar path whose ``exp`` can differ from the vector lanes' by an
    ulp."""
    if sq % q_blocks:
        raise ValueError(f"Sq={sq} not divisible into {q_blocks} query "
                         "blocks")
    per = sq // q_blocks
    outs = []
    for i in range(q_blocks):
        parts = [part(j, i * per, (i + 1) * per) for j in range(n_blocks)]
        outs.append(merge_block_partials(
            *(torch.stack(x) for x in zip(*parts))))
    return torch.cat(outs, dim)


def ring_reference(q, k, v, q_pos, kv_pos, *, n_blocks, q_blocks=1,
                   causal=True, window=None, prefix_len=None, softcap=None):
    """One-process oracle of ``ring_sdpa``: KV cut into ``n_blocks``
    contiguous blocks, the same per-block partials, the same canonical
    merge.  ``q_blocks`` is how many ranks' blocks the queries are cut
    into (``n_blocks`` for the "kv" schedule over sharded queries, 1 for
    whole ones): each is computed as its rank computes it, so that the
    ring equals this bit for bit."""
    b, sq, h, _ = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if skv % n_blocks:
        raise ValueError(f"Skv={skv} not divisible into {n_blocks} blocks "
                         "(pad with repro_torch.dist.seq.pad_kv first)")
    c = skv // n_blocks
    qg = _grouped_queries(q, kh)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    def part(j, lo, hi):
        return _block_partials(
            qg[:, :, :, lo:hi], kt[:, :, j * c:(j + 1) * c],
            vt[:, :, j * c:(j + 1) * c], q_pos[:, lo:hi],
            kv_pos[:, j * c:(j + 1) * c], causal=causal, window=window,
            prefix_len=prefix_len, softcap=softcap)

    out = _oracle_merge(part, n_blocks, q_blocks, sq, 3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1)


def _mla_block_partials(qa, qr, ckv_b, kr_b, q_pos, kp_b, *, window, scale):
    """Absorbed-MLA partial of one latent block: scores in latent space,
    the accumulator over the latent.  qa: (B,Sq,H,R) f32; qr: (B,Sq,H,P)
    f32; ckv_b: (B,c,R); kr_b: (B,c,P).  Returns (m, l, acc): (B,H,Sq),
    (B,H,Sq), (B,H,Sq,R), the queries in pieces as ``_block_partials``."""
    b, sq, h, _ = qa.shape
    c = ckv_b.shape[1]
    cb = ckv_b.to(torch.float32).contiguous()
    kb = kr_b.to(torch.float32).contiguous()
    rows = _ring_rows(h * c * b, sq)
    ms, ls, accs = [], [], []
    for r0 in range(0, sq, rows):
        qac = qa[:, r0:r0 + rows].contiguous()
        qrc = qr[:, r0:r0 + rows].contiguous()
        s = (torch.einsum("bqhr,bsr->bhqs", qac, cb)
             + torch.einsum("bqhp,bsp->bhqs", qrc, kb)) * scale
        mask = _allowed(q_pos[:, r0:r0 + rows], kp_b, causal=True,
                        window=window)
        s = _masked(s, mask[:, None])
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqs,bsr->bhqr", p, cb))
    return (torch.cat(ms, 2), torch.cat(ls, 2), torch.cat(accs, 2))


def ring_mla(qa, q_rope, ckv, krope, q_pos, kv_pos, *, mesh, axes,
             n_blocks, rotate="stats", window=None, scale):
    """Absorbed-MLA decode over a latent cache cut over the ring ``axes``,
    on this rank's pieces (its latent block).  Returns o_lat
    (B,Sq,H,R); the W_uv expansion stays with the caller."""
    b, sq, h, r = qa.shape
    qa = qa.to(torch.float32)
    qr = q_rope.to(torch.float32)

    def local_partial(ops):
        cb, kb, kp = ops
        return _mla_block_partials(qa, qr, cb, kb, q_pos, kp, window=window,
                                   scale=scale)

    shp = (n_blocks, b, h, sq)
    out = _ring_run(mesh, axes, n_blocks, rotate, local_partial,
                    (ckv, krope, kv_pos), (shp, shp, shp + (r,)), qa.device)
    return out.permute(0, 2, 1, 3)            # (B,H,Sq,R) -> (B,Sq,H,R)


def ring_mla_reference(qa, q_rope, ckv, krope, q_pos, kv_pos, *, n_blocks,
                       window=None, scale):
    """One-process oracle of ``ring_mla`` (same partials, same merge)."""
    skv = ckv.shape[1]
    if skv % n_blocks:
        raise ValueError(f"Skv={skv} not divisible into {n_blocks} blocks")
    c = skv // n_blocks
    qa = qa.to(torch.float32)
    qr = q_rope.to(torch.float32)

    def part(j, lo, hi):
        return _mla_block_partials(
            qa[:, lo:hi], qr[:, lo:hi], ckv[:, j * c:(j + 1) * c],
            krope[:, j * c:(j + 1) * c], q_pos[:, lo:hi],
            kv_pos[:, j * c:(j + 1) * c], window=window, scale=scale)

    return _oracle_merge(part, n_blocks, 1, qa.shape[1], 2).permute(
        0, 2, 1, 3)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def kv_quantized(cfg: ModelConfig) -> bool:
    if cfg.kv_quant == "none":
        return False
    if cfg.kv_quant != "bp8":
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}")
    if cfg.attention_type == "mla":
        raise ValueError("kv_quant='bp8' is GQA/MQA-only; the MLA latent "
                         "cache is already compressed")
    return True


def kv_cache_spec(cfg: ModelConfig, batch: int, length: int,
                  ring: bool = False,
                  kv_heads: Optional[int] = None) -> Dict[str, tuple]:
    """One attention layer's cache: {leaf: (shape, dtype)}.  A ``ring``
    cache of a windowed layer keeps ``min(length, window)`` slots,
    addressed pos % slots.  ``kv_heads``: the heads a rank holds under a
    TP plan (default all)."""
    if ring and cfg.window_size:
        length = min(length, cfg.window_size)
    kh, d = kv_heads or cfg.num_kv_heads, cfg.head_dim
    quant = kv_quantized(cfg)       # raises for mla + kv_quant='bp8'
    if cfg.attention_type == "mla":
        return {
            "ckv": ((batch, length, cfg.kv_lora_rank), torch.bfloat16),
            "krope": ((batch, length, cfg.qk_rope_head_dim), torch.bfloat16),
            "pos": ((batch, length), torch.int32),
        }
    if quant:
        # int8 sign*level codes + one f32 scale per (token, kv-head), so
        # appends never re-encode neighbours and scales page with tokens
        return {
            "k_codes": ((batch, length, kh, d), torch.int8),
            "k_scale": ((batch, length, kh), torch.float32),
            "v_codes": ((batch, length, kh, d), torch.int8),
            "v_scale": ((batch, length, kh), torch.float32),
            "pos": ((batch, length), torch.int32),
        }
    return {
        "k": ((batch, length, kh, d), torch.bfloat16),
        "v": ((batch, length, kh, d), torch.bfloat16),
        "pos": ((batch, length), torch.int32),
    }


def kv_cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axis names per stacked cache leaf: "batch" then "kv_seq"
    (the names the paged block pool keys on)."""
    def ax(*names):
        return ("stack", "batch") + names

    quant = kv_quantized(cfg)       # raises for mla + kv_quant='bp8'
    if cfg.attention_type == "mla":
        return {"ckv": ax("kv_seq", None), "krope": ax("kv_seq", None),
                "pos": ax("kv_seq")}
    if quant:
        return {"k_codes": ax("kv_seq", "kv_heads", None),
                "k_scale": ax("kv_seq", "kv_heads"),
                "v_codes": ax("kv_seq", "kv_heads", None),
                "v_scale": ax("kv_seq", "kv_heads"),
                "pos": ax("kv_seq")}
    return {"k": ax("kv_seq", "kv_heads", None),
            "v": ax("kv_seq", "kv_heads", None),
            "pos": ax("kv_seq")}


def _cache_write(cache: Dict[str, torch.Tensor],
                 updates: Dict[str, torch.Tensor],
                 pos) -> Dict[str, torch.Tensor]:
    """Write one token (Sq=1) at absolute position ``pos`` (in place).

    ``pos`` is a scalar (every row writes the same slot) or a (B,) tensor
    (per-row positions, as the paged engine decodes).  Slot = pos % len.
    """
    n, b = cache["pos"].shape[1], cache["pos"].shape[0]
    pos = torch.as_tensor(pos, device=cache["pos"].device)
    if pos.dim() == 0:
        slot = int(pos) % n
        for key, val in updates.items():
            cache[key][:, slot] = val[:, 0].to(cache[key].dtype)
        cache["pos"][:, slot] = pos.to(torch.int32)
        return cache
    rows = torch.arange(b, device=pos.device)
    slot = pos.to(torch.int64) % n
    for key, val in updates.items():
        cache[key][rows, slot] = val[:, 0].to(cache[key].dtype)
    cache["pos"][rows, slot] = pos.to(torch.int32)
    return cache


def _cache_write_block(cache: Dict[str, torch.Tensor],
                       updates: Dict[str, torch.Tensor], pos,
                       lo: int) -> Dict[str, torch.Tensor]:
    """``_cache_write`` into this rank's block of a seq-sharded cache,
    which holds positions [lo, lo + c) at slots pos - lo (in place): a
    row whose position lies in another rank's block is that rank's to
    write."""
    c = cache["pos"].shape[1]
    pos = torch.as_tensor(pos, device=cache["pos"].device)
    if pos.dim() == 0:
        p = int(pos)
        if lo <= p < lo + c:
            for key, val in updates.items():
                cache[key][:, p - lo] = val[:, 0].to(cache[key].dtype)
            cache["pos"][:, p - lo] = p
        return cache
    # every row writes a slot of the block, a row of another rank's block
    # its slot's own value back: no host sync on which rows are this
    # rank's
    rows = torch.arange(pos.shape[0], device=pos.device)
    mine = (pos >= lo) & (pos < lo + c)
    slot = (pos.to(torch.int64) - lo).clamp(0, c - 1)
    for key, val in updates.items():
        old = cache[key][rows, slot]
        keep = mine.reshape((-1,) + (1,) * (old.dim() - 1))
        cache[key][rows, slot] = torch.where(
            keep, val[:, 0].to(cache[key].dtype), old)
    cache["pos"][rows, slot] = torch.where(mine, pos.to(torch.int32),
                                           cache["pos"][rows, slot])
    return cache


def _prefill_block(cache: Dict[str, torch.Tensor],
                   updates: Dict[str, torch.Tensor], q_pos: torch.Tensor,
                   lo: int) -> Dict[str, torch.Tensor]:
    """Prefill's write into this rank's block of a seq-sharded cache
    (positions [lo, lo + c)) from the whole prompt's ``updates`` (B, S,
    ...) at positions ``q_pos`` (B, S) = 0..S-1 (in place)."""
    hi = min(lo + cache["pos"].shape[1], q_pos.shape[1])
    if hi > lo:
        for key, val in updates.items():
            cache[key][:, :hi - lo] = val[:, lo:hi].to(cache[key].dtype)
        cache["pos"][:, :hi - lo] = q_pos[:, lo:hi].to(torch.int32)
    return cache


def _cache_append(cache: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor],
                  q_pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Append a contiguous chunk at slots [p0, p0+Sq) (in place).

    ``q_pos`` is the (B, Sq) position array of the chunk; rows share one
    contiguous span, so the slots come from row 0."""
    slots = q_pos[0].to(torch.int64)
    for key, val in updates.items():
        cache[key].index_copy_(1, slots, val.to(cache[key].dtype))
    cache["pos"].index_copy_(1, slots, q_pos.to(torch.int32))
    return cache


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def gqa_defs(cfg: ModelConfig, dtype=torch.bfloat16):
    h, kh, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    defs = {
        "wq": linear_def(dm, h * d, "d_model", "heads", dtype),
        "wk": linear_def(dm, kh * d, "d_model", "kv_heads", dtype),
        "wv": linear_def(dm, kh * d, "d_model", "kv_heads", dtype),
        "wo": linear_def(h * d, dm, "heads", "d_model", dtype),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * d,), ("heads",), dtype, "zeros")
        defs["bk"] = ParamDef((kh * d,), ("kv_heads",), dtype, "zeros")
        defs["bv"] = ParamDef((kh * d,), ("kv_heads",), dtype, "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = norm_def(d)
        defs["k_norm"] = norm_def(d)
    return defs


def gqa_apply(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              *, window: Optional[int], cache: Optional[Dict] = None,
              prefix_len: Optional[torch.Tensor] = None,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, rope: bool = True, append: bool = False):
    """Returns (out, cache).  Modes:
       * no cache: self-attention over x (``causal=False``: every token
         sees every other, as whisper's encoder);
       * cross attention (``cross_kv``, (B, F, KH, D) each): the queries
         attend the given K/V over positions ``arange(F)``, unmasked and
         without RoPE; no cache;
       * decode (Sq == 1): write one slot, attend over the cache — through
         the fused kernel when the cache is BP8 and there is no
         ``prefix_len`` and no ring (with either, over the dequantised
         cache, as the reference's);
       * chunked prefill (``append``): append the Sq tokens at slots
         [p0, p0+Sq) and attend over the whole cache (refused for a ring
         cache, ``cfg.ring_cache``, and under a ring);
       * prefill: write the cache densely from slot 0; a cache of n < Sq
         slots (a ring) keeps the last n tokens, at slots pos % n.
    A quantised cache is attended as the values it stores (dequantised
    codes), so decode over it reproduces prefill's logits.  ``rope=False``
    skips the rotary embedding (whisper's learned positions).

    Under a ring (``dist.seq.use_ring`` and rules that shard "kv_seq"),
    the cache is this rank's block of a seq-sharded one: decode writes
    its token only on the rank whose block holds it, prefill writes the
    block from the whole prompt's keys (gathered over the ring when the
    rows are sharded), and attention runs through ``seq.ring_attend``.

    Under a TP plan that splits the heads (``dist/tp.py``: training, or
    serving on a mesh, ``dist/serving.py``) the layer runs this rank's q
    heads and the kv heads they read ("shard": its block of them;
    "group": the one its q-head block maps to, sliced before any cache
    write), the cache holds those kv heads, and ``wo`` is row-parallel.
    """
    b, sq, _ = x.shape
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mode = cfg.matmul_mode
    # tensor parallelism (training or serving under a plan, dist/tp.py):
    # wq/wo (and in "shard" kv mode wk/wv) hold this rank's heads, and so
    # does a cache; the local head counts come from the weights' shapes
    tpc = _tp.current_tp()
    tp_attn = (tpc is not None and tpc.plan.shard_heads
               and cross_kv is None)
    group = tp_attn and tpc.plan.kv_mode == _tp.KV_GROUP
    col = "col" if tp_attn else None
    q = dense(x, p["wq"], mode, p.get("bq"), tp=col).reshape(b, sq, -1, d)
    h_loc = q.shape[2]
    q_pos = positions if positions.dim() == 2 else positions[None].expand(
        b, sq)
    if cross_kv is not None:
        k, v = cross_kv
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        kv_pos = _frame_positions(b, k.shape[1], x.device)
        out = sdpa(q, k, v, q_pos, kv_pos, causal=False, window=window,
                   chunk=cfg.attn_chunk, softcap=cfg.logit_softcap,
                   prefix_len=prefix_len)
        out = dense(out.reshape(b, sq, h * d).to(x.dtype), p["wo"], mode)
        return out, cache
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if group:   # replicated leaves whose use is split: "g" on each
        wk, wv = _tp.tp_gather(wk, tpc), _tp.tp_gather(wv, tpc)
        bk = None if bk is None else _tp.tp_gather(bk, tpc)
        bv = None if bv is None else _tp.tp_gather(bv, tpc)
    if tp_attn and cfg.qk_norm:
        q_norm, k_norm = (_tp.tp_gather(q_norm, tpc),
                          _tp.tp_gather(k_norm, tpc))
    k = dense(x, wk, mode, bk, tp=col).reshape(b, sq, -1, d)
    v = dense(x, wv, mode, bv, tp=col).reshape(b, sq, -1, d)
    if group:
        # kv_heads < tp: every rank computes the whole (small) k/v and
        # keeps the one kv head its contiguous q-head block maps to,
        # before any cache write (the cache holds that head only)
        kvh = _tp.group_kv_head(cfg, tpc.plan.size, _tp.tp_index(tpc))
        k, v = k[:, :, kvh:kvh + 1], v[:, :, kvh:kvh + 1]
    kh_loc = k.shape[2]
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    quant = cache is not None and kv_quantized(cfg)
    if quant:
        kc, ks = kq.quantize_kv(k)
        vc, vs = kq.quantize_kv(v)
        updates = {"k_codes": kc, "k_scale": ks, "v_codes": vc,
                   "v_scale": vs}
    else:
        updates = {"k": k, "v": v}
    # sequence parallelism (dist/seq.py): the cache may be this rank's
    # block of a seq-sharded one, and the rows a block of the prompt's
    ring = _seq.current_ring()
    kv_lay = None if ring is None or cache is None else _seq.kv_ring(b)
    out = None
    if cache is None:
        k_all, v_all, kv_pos = k, v, q_pos
    elif sq == 1:
        if kv_lay is None:
            _cache_write(cache, updates, q_pos[:, 0])
        else:
            _cache_write_block(cache, updates, q_pos[:, 0],
                               kv_lay.index * cache["pos"].shape[1])
        if quant and prefix_len is None and ring is None:
            # codes stream into the kernel and dequantise on chip; the
            # cache is never expanded in device memory
            qg = q[:, 0].reshape(b, kh_loc, h_loc // kh_loc, d).to(
                torch.float32)
            qg = qg / _sqrt_d(d, qg.device)
            o = kq.bp8_decode_attention(
                qg.contiguous(), cache["k_codes"], cache["k_scale"],
                cache["v_codes"], cache["v_scale"], cache["pos"],
                q_pos[:, 0].to(torch.int32).contiguous(), window,
                softcap=cfg.logit_softcap, causal=causal)
            out = o.reshape(b, 1, h_loc, d)
        elif quant:
            k_all = kq.dequantize_kv(cache["k_codes"], cache["k_scale"])
            v_all = kq.dequantize_kv(cache["v_codes"], cache["v_scale"])
            kv_pos = cache["pos"]
        else:
            k_all, v_all, kv_pos = cache["k"], cache["v"], cache["pos"]
    elif append:
        if cfg.ring_cache:
            raise ValueError("chunked prefill cannot append to a ring cache")
        if ring is not None:
            raise NotImplementedError(f"chunked prefill under a ring "
                                      f"{_seq.NEEDS_NEXT}")
        _cache_append(cache, updates, q_pos)
        if quant:
            k_all = kq.dequantize_kv(cache["k_codes"], cache["k_scale"])
            v_all = kq.dequantize_kv(cache["v_codes"], cache["v_scale"])
        else:
            k_all, v_all = cache["k"], cache["v"]
        kv_pos = cache["pos"]
    else:
        n = cache["pos"].shape[1]
        if kv_lay is not None:  # this rank's block of the whole prompt's
            whole = (updates, q_pos) if ring.rows is None else (
                {key: _seq.gather_rows(val) for key, val in updates.items()},
                _seq.gather_rows(q_pos))
            _prefill_block(cache, *whole, kv_lay.index * n)
        elif n < sq:    # a ring keeps the last n tokens at slots pos % n
            slots = torch.arange(sq - n, sq, device=x.device) % n
            for key, val in updates.items():
                cache[key][:, slots] = val[:, sq - n:].to(cache[key].dtype)
            cache["pos"][:, slots] = q_pos[:, sq - n:].to(torch.int32)
        else:
            for key, val in updates.items():
                cache[key][:, :sq] = val.to(cache[key].dtype)
            cache["pos"][:, :sq] = q_pos.to(torch.int32)
        if quant:
            k_all, v_all = kq.dequantize_kv(kc, ks), kq.dequantize_kv(vc, vs)
        else:
            k_all, v_all = k, v
        kv_pos = q_pos
    if out is None:
        if ring is not None and not tp_attn:
            # the ring over the seq-sharded KV: decode's is the cache
            # block, prefill's the rank's block of the prompt when its
            # rows are sharded (else the whole prompt, cut there); None
            # where the rules leave this KV whole
            out = _seq.ring_attend(
                q, k_all, v_all, q_pos, kv_pos,
                kv_logical="kv_seq" if cache is not None else "seq",
                kv_local=(cache is not None and sq == 1)
                or ring.rows is not None,
                causal=causal, window=window, prefix_len=prefix_len,
                softcap=cfg.logit_softcap)
    if out is None:
        out = sdpa(q, k_all, v_all, q_pos, kv_pos, causal=causal,
                   window=window, chunk=cfg.attn_chunk,
                   softcap=cfg.logit_softcap, prefix_len=prefix_len)
    out = dense(out.reshape(b, sq, h_loc * d).to(x.dtype), p["wo"], mode,
                tp="row" if tp_attn else None)
    return out, cache


@device_constant
def _frames_arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _frame_positions(b: int, n: int, device) -> torch.Tensor:
    """(B, F) positions ``arange(F)`` of cross-attention keys, made once
    per (F, device) so that a captured graph needs no host copy."""
    return _frames_arange(n, device)[None].expand(b, n)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): minicpm3, deepseek-v2
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig, dtype=torch.bfloat16):
    dm, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    defs = {
        "wdkv": linear_def(dm, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                           "d_model", "lora", dtype),
        "kv_norm": norm_def(cfg.kv_lora_rank),
        "wuk": ParamDef((cfg.kv_lora_rank, h, cfg.qk_nope_head_dim),
                        ("lora", "heads", None), dtype),
        "wuv": ParamDef((cfg.kv_lora_rank, h, cfg.v_head_dim),
                        ("lora", "heads", None), dtype),
        "wo": linear_def(h * cfg.v_head_dim, dm, "heads", "d_model", dtype),
    }
    if cfg.q_lora_rank:
        defs["wdq"] = linear_def(dm, cfg.q_lora_rank, "d_model", "lora", dtype)
        defs["q_norm"] = norm_def(cfg.q_lora_rank)
        defs["wuq"] = linear_def(cfg.q_lora_rank, h * qk, "lora", "heads",
                                 dtype)
    else:
        defs["wq"] = linear_def(dm, h * qk, "d_model", "heads", dtype)
    return defs


def _mla_q(p, cfg: ModelConfig, x: torch.Tensor, tpc=None):
    """(q_nope, q_rope): (B, S, H, nope) and (B, S, H, rope); under a TP
    plan ``tpc`` the rank's heads (the latent ``wdq``/``q_norm``
    replicated, their output entering the split through "g")."""
    b, s, _ = x.shape
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    mode = cfg.matmul_mode
    col = "col" if tpc is not None else None
    if cfg.q_lora_rank:
        ql = rms_norm(dense(x, p["wdq"], mode), p["q_norm"], cfg.norm_eps)
        q = dense(ql, p["wuq"], mode, tp=col)
    else:
        q = dense(x, p["wq"], mode, tp=col)
    q = q.reshape(b, s, -1, qk)
    return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _mla_expand(p, cfg: ModelConfig, q_nope, q_rope, ckv, krope):
    """K/V expanded from f32 latents, and q: k = [ckv W_uk, krope]
    (krope shared by every head), v = ckv W_uv."""
    k_nope = torch.einsum("bsr,rhd->bshd", ckv, p["wuk"].to(torch.float32))
    v = torch.einsum("bsr,rhv->bshv", ckv, p["wuv"].to(torch.float32))
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope.to(torch.float32), q_rope.to(torch.float32)],
                  dim=-1)
    return q, k, v


def mla_apply(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              *, cache: Optional[Dict] = None, window=None,
              append: bool = False):
    """Returns (out, cache).  Training and prefill expand K/V from the
    latent (prefill from the bf16-rounded latents it stores, so a later
    absorbed decode reproduces its logits); chunked prefill (``append``)
    appends the latents at [p0, p0+Sq) and expands K/V from the whole
    cache; decode (Sq == 1) is absorbed: W_uk folds into q and the scores
    are taken in the kv_lora latent space in f32, O(S * kv_lora) a step
    instead of O(S * H * head_dim).  Under a ring (``dist.seq``) the
    latent cache is this rank's block of a seq-sharded one: decode rings
    the absorbed scores over it (``seq.ring_attend_mla``), and prefill,
    which the reference does not ring, gathers the latents of sharded rows
    over the ring, attends this rank's queries over the whole sequence
    and writes the rank's block.  Under a TP plan that splits the heads
    every branch runs this rank's heads (``_mla_q``, ``wuk``, ``wuv``),
    the latents and their cache are whole on every rank, and ``wo`` is
    row-parallel."""
    b, sq, _ = x.shape
    mode = cfg.matmul_mode
    # tensor parallelism (training or serving under a plan, dist/tp.py):
    # the latent projections are replicated and the latent cache whole on
    # every rank, wuq/wuk/wuv/wo hold this rank's heads
    tpc = _tp.current_tp()
    tpc = tpc if (tpc is not None and tpc.plan.shard_heads) else None
    q_nope, q_rope = _mla_q(p, cfg, x, tpc)
    dkv = dense(x, p["wdkv"], mode)
    ckv = rms_norm(dkv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    krope = dkv[..., cfg.kv_lora_rank:]                     # (B, S, rope)
    q_pos = positions if positions.dim() == 2 else positions[None].expand(
        b, sq)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]
    updates = {"ckv": ckv, "krope": krope}
    # sequence parallelism (dist/seq.py): the latent cache may be this
    # rank's block of a seq-sharded one, and the rows a block of the
    # prompt's
    ring = _seq.current_ring()
    kv_lay = None if ring is None or cache is None else _seq.kv_ring(b)
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim

    if cache is not None and sq == 1:
        # ---- absorbed decode ----
        if kv_lay is None:
            _cache_write(cache, updates, q_pos[:, 0])
        else:
            _cache_write_block(cache, updates, q_pos[:, 0],
                               kv_lay.index * cache["pos"].shape[1])
        kv_pos = cache["pos"]
        qa = torch.einsum("bqhd,rhd->bqhr", q_nope.to(torch.float32),
                          p["wuk"].to(torch.float32))
        o_lat = None
        if ring is not None:    # the ring over the seq-sharded latents
            o_lat = _seq.ring_attend_mla(
                qa, q_rope.to(torch.float32), cache["ckv"], cache["krope"],
                q_pos, kv_pos, window=window,
                scale=_sdpa_scale(qk, x.device))
        if o_lat is None:
            ckv_all = cache["ckv"].to(torch.float32)         # (B, S, R)
            kr_all = cache["krope"].to(torch.float32)        # (B, S, P)
            s_nope = torch.einsum("bqhr,bsr->bhqs", qa, ckv_all)
            s_rope = torch.einsum("bqhp,bsp->bhqs",
                                  q_rope.to(torch.float32), kr_all)
            scores = (s_nope + s_rope) * _sdpa_scale(qk, x.device)
            mask = _allowed(q_pos, kv_pos, causal=True, window=window)
            pr = torch.softmax(_masked(scores, mask[:, None]), dim=-1)
            o_lat = torch.einsum("bhqs,bsr->bqhr", pr, ckv_all)
        out = torch.einsum("bqhr,rhv->bqhv", o_lat,
                           p["wuv"].to(torch.float32))
    elif cache is not None and append:
        # ---- chunked prefill: attend every previously appended chunk,
        # expanded from the bf16-stored latents absorbed decode reads ----
        if ring is not None:
            raise NotImplementedError(f"chunked prefill under a ring "
                                      f"{_seq.NEEDS_NEXT}")
        _cache_append(cache, updates, q_pos)
        q, k, v = _mla_expand(p, cfg, q_nope, q_rope,
                              cache["ckv"].to(torch.float32),
                              cache["krope"].to(torch.float32))
        out = sdpa(q, k, v, q_pos, cache["pos"], causal=True, window=window,
                   chunk=cfg.attn_chunk)
    else:
        # ---- expanded train / prefill ----
        # (prefill expands from the bf16 latents it stores; under a ring
        # with sharded rows, from every rank's, gathered: MLA prefill is
        # not ringed, its attention sees the whole sequence)
        dt = torch.bfloat16 if cache is not None else torch.float32
        lat, kv_pos = {"ckv": ckv.to(dt), "krope": krope.to(dt)}, q_pos
        if ring is not None and ring.rows is not None:
            lat = {key: _seq.gather_rows(val) for key, val in lat.items()}
            kv_pos = _seq.gather_rows(q_pos)
        ckv_e, kr_e = (lat[key].to(torch.float32) for key in lat)
        if tpc is not None:   # the shared latents enter the head split
            ckv_e = _tp.tp_gather(ckv_e, tpc)
            kr_e = _tp.tp_gather(kr_e, tpc)
        q, k, v = _mla_expand(p, cfg, q_nope, q_rope, ckv_e, kr_e)
        out = sdpa(q, k, v, q_pos, kv_pos, causal=True, window=window,
                   chunk=cfg.attn_chunk)
        if kv_lay is not None:                  # prefill: store latents
            _prefill_block(cache, lat, kv_pos,
                           kv_lay.index * cache["pos"].shape[1])
        elif cache is not None:
            for key, val in lat.items():
                cache[key][:, :sq] = val
            cache["pos"][:, :sq] = q_pos.to(torch.int32)
    out = out.reshape(b, sq, -1).to(x.dtype)
    return dense(out, p["wo"], mode,
                 tp="row" if tpc is not None else None), cache
