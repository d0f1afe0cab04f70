"""Common layers: matmul dispatch, RMSNorm, rotary embeddings, MLP, and
the chunked cross-entropy of training.

``dense`` is where the paper's technique plugs in: under
``matmul_mode="bp8_fused"`` every projection is an OISMA matmul run by
the fused kernel, with the plain f32 matmul's gradients
(straight-through, ``ops.oisma_matmul_ste``); ``"bp8"`` and ``"bp8_lowrank"`` run the bit-exact
bitplane or low-rank formulation as plain f32 matmuls with a
straight-through gradient (``core/bp_matmul.py``); ``"fp8"`` is the
paper's E4M3 baseline; ``"bf16"`` is the plain bf16 matmul.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import bp_matmul as _bpm
from repro_torch.core import quantize as _q
from repro_torch.device import device_constant
from repro_torch.dist import tp as _tp
from repro_torch.kernels import ops as _ops
from repro_torch.models.params import ParamDef


def dense(x: torch.Tensor, w: torch.Tensor, mode: str = "bf16",
          bias: Optional[torch.Tensor] = None,
          tp: Optional[str] = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) under the configured matmul mode.

    ``tp`` marks a projection under an installed TP plan (``dist/tp.py``):
    "col" (w holds this rank's output columns) or "row" (its input rows:
    the output is summed over the TP group).  A "col" projection's input
    enters through "g" in f32, so that its gradient is summed before its
    one cast; a "row" one's BP output is summed in f32 before the cast in
    the global regime, after it per shard (the reference's psum follows
    ``dense``), and a bf16 one in f32 in both."""
    tpc = _tp.current_tp() if tp else None
    col, row = tpc is not None and tp == "col", tpc is not None and \
        tp == "row"
    if row and bias is not None:
        raise ValueError("a row-parallel projection takes no bias")
    if mode == "bf16" and (row or col):
        # a split bf16 matmul in f32 (its products are exact), summed or
        # back-propagated in f32 and cast once, as the whole matmul's
        # f32 accumulation is: no scale is involved, in either regime
        xf = x.to(torch.float32)
        if col:
            xf = _tp.tp_gather(xf, tpc)
        y = torch.matmul(xf, w.to(x.dtype).to(torch.float32))
        if row:
            y = _tp.tp_psum(y, tpc)
        y = y.to(x.dtype)
    elif mode in ("bf16", "fp8"):
        if col:
            x = _tp.tp_gather(x, tpc)
        if mode == "bf16":
            y = torch.matmul(x, w.to(x.dtype))
        else:
            xq = _q.fake_quantize_e4m3(x.to(torch.float32))
            wq = _q.fake_quantize_e4m3(w.to(torch.float32))
            y = torch.matmul(xq, wq).to(x.dtype)
        if row:
            y = _tp.tp_psum(y, tpc)
    elif mode in ("bp8", "bp8_lowrank", "bp8_fused"):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        if col:     # "g" in f32: each projection's gradient cast once
            x2 = _tp.tp_gather(x2, tpc)
        if mode == "bp8_fused":         # w as held: the kernels read bf16
            y = _ops.oisma_matmul_ste(x2, w)
        else:
            y = _bpm.bp_matmul_ste(
                x2, w.to(torch.float32),
                impl="bitplane" if mode == "bp8" else "lowrank")
        if row and tpc.exact:
            y = _tp.tp_psum(y, tpc)
        y = y.reshape(*lead, w.shape[-1]).to(x.dtype)
        if row and not tpc.exact:
            y = _tp.tp_psum(y, tpc)
    else:
        raise ValueError(f"unknown matmul mode {mode!r}")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def linear_def(d_in: int, d_out: int, in_axis: str, out_axis: str,
               dtype=torch.bfloat16, scale: float = 1.0) -> ParamDef:
    return ParamDef((d_in, d_out), (in_axis, out_axis), dtype, "normal", scale)


def norm_def(d: int) -> ParamDef:
    return ParamDef((d,), (None,), torch.float32, "zeros")


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with the ``(1 + gamma)`` gain, cast back to x's type."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 (mean, then the biased variance ``jnp.var``
    takes: the mean of the squared deviations), cast back to x's type."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    dev = xf - mu
    var = torch.mean(dev * dev, dim=-1, keepdim=True)
    y = dev * torch.rsqrt(var + eps)
    return (y * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def ln_defs(d: int):
    return {"gamma": ParamDef((d,), (None,), torch.float32, "ones"),
            "beta": ParamDef((d,), (None,), torch.float32, "zeros")}


@device_constant
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """(head_dim / 2,) f32 rotary frequencies, made once per device."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Half-split rotation."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., None] * freqs[None, None, :]            # (B, S, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A constant in x's dtype, as a weak-typed Python scalar is in jax."""
    return torch.tensor(v, dtype=like.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """jax.nn's definitions op for op, each op rounding to x's dtype, so a
    bf16 activation rounds where the reference's does (XLA expands the
    logistic as ``1 / (1 + exp(-x))`` in the input's type)."""
    if kind == "silu":
        one = _const(1.0, x)
        return x * (one / (one + torch.exp(-x)))
    if kind == "gelu":                      # the tanh approximation
        inner = x + _const(0.044715, x) * (x * x * x)
        cdf = _const(0.5, x) * (_const(1.0, x) + torch.tanh(
            _const(math.sqrt(2 / math.pi), x) * inner))
        return x * cdf
    if kind == "relu":
        return torch.clamp_min(x, 0)
    raise ValueError(kind)


def mlp_defs(d_model: int, d_ff: int, gated: bool, dtype=torch.bfloat16):
    defs = {
        "up": linear_def(d_model, d_ff, "d_model", "ffn", dtype),
        "down": linear_def(d_ff, d_model, "ffn", "d_model", dtype),
    }
    if gated:
        defs["gate"] = linear_def(d_model, d_ff, "d_model", "ffn", dtype)
    return defs


def mlp_apply(p, x: torch.Tensor, act: str, gated: bool,
              mode: str) -> torch.Tensor:
    """Under a TP plan that splits the ffn dim, up and gate are
    column-parallel and down row-parallel (``dist/tp.py``)."""
    tpc = _tp.current_tp()
    tp_on = tpc is not None and tpc.plan.shard_ffn
    if mode == "bp8_fused" and gated and act in ("silu", "gelu", "relu"):
        # one kernel: up and gate share one BP encode of x, the weights
        # are read as held, and the two (tokens, d_ff) projections never
        # reach device memory
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        if tp_on:
            x2 = _tp.tp_gather(x2, tpc)
        up = _ops.oisma_mlp_ste(x2, p["up"], p["gate"], act=act)
        up = up.reshape(*lead, p["up"].shape[-1]).to(x.dtype)
    else:
        col = "col" if tp_on else None
        up = dense(x, p["up"], mode, tp=col)
        if gated:
            up = activation(dense(x, p["gate"], mode, tp=col), act) * up
        else:
            up = activation(up, act)
    return dense(up, p["down"], mode, tp="row" if tp_on else None)


def embed_def(vocab: int, d_model: int, dtype=torch.bfloat16) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "d_model"), dtype, "embed")


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 scale: bool = False, split=None) -> torch.Tensor:
    """Rows of ``table``; with ``scale`` times sqrt(d_model), that factor
    computed in f32 and rounded to the table's dtype before the multiply
    (62.0 at 3840 and 45.25 at 2048 in bf16), as the reference's.

    ``split`` = (mesh, axes): ``table`` is this rank's contiguous slice of
    a vocabulary cut over ``axes``; each rank looks up the ids in its
    slice, -0.0 elsewhere, and the ranks sum.  The sum is exact, signed
    zeros too: every other term is -0.0, which adds nothing."""
    if split is None:
        out = table[ids]
    else:
        mesh, axes = split
        n = table.shape[0]
        local = ids - mesh.index(axes) * n
        mine = (local >= 0) & (local < n)
        out = table[local.clamp(0, n - 1)]
        out = torch.where(mine[..., None], out,
                          torch.full((), -0.0, dtype=out.dtype,
                                     device=out.device))
        mesh.all_reduce(out, axes)
    if scale:
        out = out * _embed_scale(table.shape[-1], out.dtype, out.device)
    return out


@device_constant
def _embed_scale(d: int, dtype, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(d), dtype=torch.float32)).to(
        dtype).to(device)


def chunked_softmax_xent(h: torch.Tensor, embed: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512, softcap: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over a large vocab without forming (B, S, V) at once:
    f32 logits one sequence chunk at a time (``embed`` is (V, D)), their
    ``logsumexp``, the gold logit, the mask.  Returns (sum_loss,
    sum_mask)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    ef = embed.to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        hc = h[:, lo:lo + chunk].to(torch.float32)
        logits = torch.einsum("bsd,vd->bsv", hc, ef)
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, lo:lo + chunk, None].long())[..., 0]
        total = total + ((lse - gold) * mask[:, lo:lo + chunk]).sum()
    return total, mask.sum()
