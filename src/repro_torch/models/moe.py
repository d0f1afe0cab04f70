"""Mixture-of-Experts with top-k routing and capacity-based dispatch.

The reference's layer (``moe_apply``) on one device: the router in f32,
softmax, top-k with renormalised weights, the Switch auxiliary loss,
a capacity per expert, each (token, slot)'s rank within its expert
(stable: token order, then slot order), slots past the capacity
dropped, the kept slots in (E, C, d) buffers, the expert FFNs batched
over all E experts as plain matmuls in the activations' type, and the
weighted combine in f32, plus the shared experts through ``dense`` in
the config's matmul mode.

Under a TP plan (training, ``dist/tp.py``) the routed experts split over
the TP ranks (expert parallelism): the router stays replicated (every
rank routes every token, the ranks, the capacity and the aux loss
alike), ``up``/``gate``/``down`` hold a contiguous block of experts,
each rank dispatches the slots routed to its block, and the combine is
summed over the ranks ("f"); the routing weights enter the split
through "g", so that the router's gradient is whole.  The shared
experts split their ffn dim like a dense MLP.

Every step is a fixed-shape tensor op with no host round trip, so the
layer runs inside a captured CUDA graph: the capacity is a Python int
from the static token count, the per-expert counts come from a
``scatter_add_`` (``bincount`` would size its output from the data),
and top-k is a stable descending sort, which breaks ties towards the
lower expert index as ``jax.lax.top_k`` does (``torch.topk`` promises no
order among equal values).  The buffers are filled by a gather (each
cell reads the slot the sort put there) and each token's k weighted
outputs are summed left to right from zero, the reference's scatter-add
order on the CPU.  The only atomic adds are of counts, exact in any
order, so a run gives the same bits every time.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tp as _tp
from repro_torch.models.layers import activation, dense
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig, dtype=torch.bfloat16):
    dm, dff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((dm, e), ("d_model", "experts"), torch.float32),
        "up": ParamDef((e, dm, dff), ("experts", "d_model", "ffn"), dtype),
        "gate": ParamDef((e, dm, dff), ("experts", "d_model", "ffn"), dtype),
        "down": ParamDef((e, dff, dm), ("experts", "ffn", "d_model"), dtype),
    }
    if cfg.num_shared_experts:
        sdff = cfg.moe_d_ff * cfg.num_shared_experts
        defs["shared_up"] = ParamDef((dm, sdff), ("d_model", "ffn"), dtype)
        defs["shared_gate"] = ParamDef((dm, sdff), ("d_model", "ffn"), dtype)
        defs["shared_down"] = ParamDef((sdff, dm), ("ffn", "d_model"), dtype)
    return defs


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    ``int(capacity_factor * T * k / E) + 1``."""
    return int(cfg.capacity_factor * tokens * cfg.num_experts_per_tok
               / cfg.num_experts) + 1


def route(router: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor,
          capacity: int) -> Dict[str, torch.Tensor]:
    """Routing of ``xt`` (T, d): top-k weights and experts (T, k), the
    rank of each (token, slot) within its expert and whether it is kept
    (T*k,), the per-expert counts and first sorted slots (E,), the
    stable order of the slots by expert (T*k,), and the auxiliary
    loss."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = xt.shape[0]
    dev = xt.device
    logits = torch.matmul(xt.to(torch.float32), router.to(torch.float32))
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # load-balance auxiliary loss (Switch-style)
    flat_e = topi.reshape(-1)
    ones = torch.ones((t * k,), dtype=torch.float32, device=dev)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, flat_e, ones) / (t * k)
    aux = e * torch.sum(gates.mean(0) * ce)

    # rank within the expert: position after a stable sort by expert id
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros((e,), dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return {"topw": topw, "topi": topi, "rank": rank,
            "keep": rank < capacity, "counts": counts,
            "seg_start": seg_start, "order": order, "aux_loss": aux}


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """x: (B, S, d) -> {'out': (B, S, d), 'aux_loss': scalar}."""
    b, s, d = x.shape
    k = cfg.num_experts_per_tok
    t = b * s
    xt = x.reshape(t, d)
    if capacity is None:
        capacity = moe_capacity(cfg, t)
    capacity = max(capacity, 1)
    r = route(p["router"], cfg, xt, capacity)
    dev = x.device
    tpc = _tp.current_tp()
    ep = tpc is not None and tpc.plan.shard_experts
    shared_tp = (tpc is not None and tpc.plan.shard_shared
                 and cfg.num_shared_experts > 0)

    # this rank's experts [e0, e0 + e_local): all of them without EP
    e_local = p["up"].shape[0]
    e0 = _tp.tp_index(tpc) * e_local if ep else 0
    xt_e = _tp.tp_gather(xt, tpc) if ep else xt

    # dispatch: cell (e, c) holds the slot of rank c in expert e, if kept
    c_idx = torch.arange(capacity, device=dev)
    counts, seg_start = r["counts"], r["seg_start"]
    if ep:
        counts, seg_start = counts[e0:e0 + e_local], seg_start[e0:e0 + e_local]
    filled = c_idx[None, :] < counts[:, None]                      # (E, C)
    at = torch.where(filled, seg_start[:, None] + c_idx[None, :], 0)
    tok = torch.div(r["order"][at], k, rounding_mode="floor")
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    buf = torch.where(filled[..., None], xt_e[tok], zero)          # (E, C, d)

    # the expert FFNs, batched over the experts, in the activations' type
    h = activation(torch.bmm(buf, p["gate"].to(x.dtype)), cfg.act) \
        * torch.bmm(buf, p["up"].to(x.dtype))
    yb = torch.bmm(h, p["down"].to(x.dtype))                       # (E, C, d)

    # combine: each token's k weighted outputs, summed left to right
    flat_e = r["topi"].reshape(-1)
    keep = r["keep"]
    topw = r["topw"]
    loc = flat_e
    if ep:       # this rank's slots only; the weights enter the split
        keep = keep & (flat_e >= e0) & (flat_e < e0 + e_local)
        topw = _tp.tp_gather(topw, tpc)
        loc = torch.clamp(flat_e - e0, 0, e_local - 1)
    got = yb[loc, torch.where(keep, r["rank"], 0)]                 # (T*k, d)
    got = torch.where(keep[:, None], got, zero).to(torch.float32)
    w = topw.reshape(-1) * keep
    contrib = (got * w[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + contrib[:, j]

    shared_out = None
    if cfg.num_shared_experts:
        mode = cfg.matmul_mode
        col = "col" if shared_tp else None
        shared = activation(dense(xt, p["shared_gate"], mode, tp=col),
                            cfg.act) \
            * dense(xt, p["shared_up"], mode, tp=col)
        if shared_tp and tpc.exact:       # summed in f32 before its cast
            shared_out = dense(shared, p["shared_down"], mode,
                               tp="row").to(torch.float32)
            shared_tp = False
        else:
            shared_out = dense(shared, p["shared_down"],
                               mode).to(torch.float32)
    # the partial sums (this rank's experts, the split shared ffn) go
    # through one all-reduce; whole ones are added after it
    partial = out if ep else None
    whole = None if ep else out
    if shared_out is not None:
        if shared_tp:
            partial = shared_out if partial is None else partial + shared_out
        else:
            whole = shared_out if whole is None else whole + shared_out
    total = whole
    if partial is not None:
        total = _tp.tp_psum(partial, tpc)
        if whole is not None:
            total = total + whole
    return {"out": total.to(x.dtype).reshape(b, s, d),
            "aux_loss": r["aux_loss"]}
