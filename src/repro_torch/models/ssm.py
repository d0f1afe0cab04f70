"""The recurrent blocks: Mamba2 (SSD, zamba2's backbone) and xLSTM's
mLSTM (chunkwise parallel) and sLSTM (sequential).

Mamba2's chunked SSD and the chunked mLSTM are quadratic only within a
chunk and linear across chunks, for prefill and training; both have an
O(1)-state recurrence for decode.  The reference writes all three in
plain JAX (``repro/models/ssm.py``), so they are plain torch here: no
kernel of their own.  Their projections go through ``dense``, so in
``bp8_fused`` they are absmax and the fused BP matmul.

The multi-operand einsums are written as the pairwise contractions XLA
runs for the reference (the order ``jnp.einsum``'s path search picks at
every chunk shape of the served and tested paths), each an elementwise
product or one contraction.  A contraction still sums in another order
than XLA's, so the outputs agree to f32 rounding, not bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, dense, linear_def, rms_norm
from repro_torch.models.params import ParamDef


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with S[i, j] = sum_{k=j+1..i} a_k (i >= j),
    -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((q, q), dtype=torch.bool, device=a.device).triu(1)
    return s.masked_fill(upper, float("-inf"))


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, state size)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_state


def mamba2_defs(cfg: ModelConfig, dtype=torch.bfloat16):
    d_inner, nheads, n = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "in_proj": linear_def(cfg.d_model, 2 * d_inner + 2 * n + nheads,
                              "d_model", "ffn", dtype),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), ("conv", "ffn"), dtype),
        "conv_b": ParamDef((conv_dim,), ("ffn",), dtype, "zeros"),
        "a_log": ParamDef((nheads,), ("heads",), torch.float32, "zeros"),
        "dt_bias": ParamDef((nheads,), ("heads",), torch.float32, "zeros"),
        "d_skip": ParamDef((nheads,), ("heads",), torch.float32, "ones"),
        "norm": ParamDef((d_inner,), (None,), torch.float32, "zeros"),
        "out_proj": linear_def(d_inner, cfg.d_model, "ffn", "d_model", dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), and its gradient ``exp(x - out)``: 0.5 at x = 0,
    where a BP matmul's output often lands (the same expression written
    out would pass 1 there, ``clamp_min``'s and ``abs``' subgradients)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssd_chunked(x, dt, a, b, c, chunk: int, h0=None, decay_bf16=False):
    """SSD scan.  x: (B,S,H,P) dt: (B,S,H) a: (H,) b,c: (B,S,N).

    Returns (y, h_final) with h: (B,H,P,N) f32.  ``decay_bf16`` holds the
    (B,H,Nc,Q,Q) intra-chunk decay matrix and the diagonal blocks'
    operands in bf16, the products summed in f32.  A length that is not
    a multiple of the chunk (``min(chunk, S)``) is refused, as the
    reference refuses it."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"SSD: sequence length {s} is not a multiple of "
                         f"its chunk {q}")
    nc = s // q
    xr = x.reshape(bs, nc, q, h, p)
    dtr = dt.reshape(bs, nc, q, h)
    br = b.reshape(bs, nc, q, n)
    cr = c.reshape(bs, nc, q, n)
    da_h = (dtr * a).permute(0, 3, 1, 2)               # (B,H,Nc,Q) log-decay
    cs = torch.cumsum(da_h, dim=-1)                    # (B,H,Nc,Q)
    xdt = xr * dtr[..., None]                          # input * dt

    # intra-chunk (diagonal blocks): (C B^T) * L, then over s with x dt
    L = torch.exp(_segsum(da_h))                       # (B,H,Nc,Q,Q)
    if decay_bf16:
        bf = torch.bfloat16
        cb = torch.einsum("bcln,bcsn->bcls", cr.to(bf).float(),
                          br.to(bf).float())
        w = cb[:, None] * L.to(bf).float()             # (B,H,Nc,Q,Q)
        y_diag = torch.einsum("bhcls,bcshp->bclhp", w, xdt.to(bf).float())
    else:
        cb = torch.einsum("bcln,bcsn->bcls", cr, br)
        w = cb[:, None] * L
        y_diag = torch.einsum("bhcls,bcshp->bclhp", w, xdt)

    # per-chunk final states
    decay_states = torch.exp(cs[..., -1:] - cs)        # (B,H,Nc,Q)
    xw = decay_states.permute(0, 2, 3, 1)[..., None] * xdt   # (B,Nc,Q,H,P)
    states = torch.einsum("bcsn,bcshp->bchpn", br, xw)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cs[..., -1])               # (B,H,Nc)
    hcur = (h0 if h0 is not None else
            torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device))
    hprevs = []
    for i in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, :, i, None, None] + states[:, i]
    hprev = torch.stack(hprevs, dim=1)                 # (B,Nc,H,P,N)
    # off-diagonal contribution from previous chunks' state
    ce = cr[..., None] * torch.exp(cs).permute(0, 2, 3, 1)[:, :, :, None]
    y_off = torch.einsum("bclnh,bchpn->bclhp", ce, hprev)
    y = (y_diag + y_off).reshape(bs, s, h, p)
    return y, hcur


def mamba2_apply(p, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Dict] = None, chunk: int = 256):
    """x: (B,S,D); state: {'conv': (B,W-1,convdim), 'ssm': (B,H,P,N)}, f32.

    Returns (y, new_state).  With a state and S == 1 the step is the
    recurrence (decode, or a one-token prefill chunk); otherwise the
    chunked SSD continues from the state (zeros for a fresh prefill:
    the conv history then equals the zero pad), so a chunked prefill is
    an exact continuation.  ``new_state`` is None without a state."""
    bs, s, _ = x.shape
    d_inner, nheads, n = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    proj = dense(x, p["in_proj"], cfg.matmul_mode)
    z, xbc, dtp = torch.split(proj, [d_inner, conv_dim, nheads], dim=-1)

    # depthwise causal conv over xbc
    w = p["conv_w"].to(torch.float32)                  # (W, convdim)
    width = w.shape[0]
    if state is not None and s == 1:
        hist = torch.cat([state["conv"], xbc.to(torch.float32)], dim=1)
        conv_out = torch.einsum("bwc,wc->bc", hist[:, -width:], w)[:, None]
        new_conv = hist[:, -(width - 1):]
    else:
        pad = (state["conv"] if state is not None else
               torch.zeros((bs, width - 1, conv_dim), dtype=torch.float32,
                           device=x.device))
        xf = torch.cat([pad, xbc.to(torch.float32)], dim=1)
        conv_out = xf[:, 0:s] * w[0][None, None]
        for i in range(1, width):
            conv_out = conv_out + xf[:, i:i + s] * w[i][None, None]
        new_conv = xf[:, -(width - 1):]
    conv_out = activation(conv_out + p["conv_b"].to(torch.float32), "silu")

    xs, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xs = xs.reshape(bs, s, nheads, cfg.ssm_headdim)
    dt = _softplus(dtp.to(torch.float32) + p["dt_bias"][None, None])
    a = -torch.exp(p["a_log"])                         # (H,) negative

    if state is not None and s == 1:
        # recurrent step: h' = exp(dt a) h + dt B x
        da = torch.exp(dt[:, 0] * a[None])             # (B,H)
        hb = (xs[:, 0] * dt[:, 0, :, None])[..., None] * b[:, 0, None, None]
        new_ssm = state["ssm"] * da[..., None, None] + hb
        y = torch.einsum("bn,bhpn->bhp", c[:, 0], new_ssm)[:, None]
    else:
        y, new_ssm = _ssd_chunked(
            xs, dt, a, b, c, min(chunk, cfg.ssm_chunk),
            state["ssm"] if state is not None else None,
            decay_bf16=cfg.ssm_decay_bf16)
    y = y + xs * p["d_skip"][None, None, :, None]
    y = y.reshape(bs, s, d_inner)
    y = rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    y = y * activation(z.to(y.dtype), "silu")
    out = dense(y, p["out_proj"], cfg.matmul_mode)
    new_state = ({"conv": new_conv, "ssm": new_ssm}
                 if state is not None else None)
    return out, new_state


def mamba2_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    """One Mamba2 layer's recurrent state: {leaf: (shape, dtype)}."""
    d_inner, nheads, n = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "conv": ((batch, cfg.ssm_conv - 1, conv_dim), torch.float32),
        "ssm": ((batch, nheads, cfg.ssm_headdim, n), torch.float32),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunkwise parallel) and sLSTM (sequential)
# ---------------------------------------------------------------------------

def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: ``1 / (1 + exp(-x))``."""
    return 1.0 / (1.0 + torch.exp(-x))


def mlstm_inner(cfg: ModelConfig) -> int:
    """mLSTM up-projection width: 4/3 * d_model, rounded up to a multiple
    of 8 * num_heads (the xLSTM paper's proj_factor with block-diagonal
    heads)."""
    mult = 8 * cfg.num_heads
    return ((int(cfg.d_model * 4 / 3) + mult - 1) // mult) * mult


def mlstm_defs(cfg: ModelConfig, dtype=torch.bfloat16):
    d, h = cfg.d_model, cfg.num_heads
    d_inner = mlstm_inner(cfg)
    dk = d_inner // h
    return {
        "up": linear_def(d, 2 * d_inner, "d_model", "ffn", dtype),
        # block-diagonal per-head projections (xLSTM paper)
        "wq": ParamDef((h, dk, dk), ("heads", None, None), dtype),
        "wk": ParamDef((h, dk, dk), ("heads", None, None), dtype),
        "wv": ParamDef((h, dk, dk), ("heads", None, None), dtype),
        "wi": linear_def(d_inner, h, "ffn", "heads", torch.float32),
        "wf": linear_def(d_inner, h, "ffn", "heads", torch.float32),
        "norm": ParamDef((d_inner,), (None,), torch.float32, "zeros"),
        "down": linear_def(d_inner, d, "ffn", "d_model", dtype),
    }


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """Chunkwise mLSTM.  q, k, v: (B,S,H,D) f32; log_i, log_f: (B,S,H).

    Recurrence: C_t = f_t C_{t-1} + i_t k_t v_t^T ; n_t = f_t n_{t-1} +
    i_t k_t ; y_t = (q C_t) / max(|q n_t|, exp(-m_t)) with a running
    log-stabiliser m.  Quadratic inside a chunk, a loop over chunks.
    Without a state the start is C = 0, n = 0, m = -1e30.  Returns (y,
    {"C", "n", "m"}).  A length that is not a multiple of the chunk
    (``min(chunk, S)``) is refused, as the reference refuses it."""
    bs, s, h, d = q.shape
    qc = min(chunk, s)
    if s % qc:
        raise ValueError(f"mLSTM: sequence length {s} is not a multiple of "
                         f"its chunk {qc}")
    nc = s // qc
    rd = math.sqrt(d)
    qr = q.reshape(bs, nc, qc, h, d)
    kr = k.reshape(bs, nc, qc, h, d) / rd
    vr = v.reshape(bs, nc, qc, h, d)
    li = log_i.reshape(bs, nc, qc, h).permute(0, 3, 1, 2)    # (B,H,Nc,Q)
    lf = log_f.reshape(bs, nc, qc, h).permute(0, 3, 1, 2)
    csf = torch.cumsum(lf, dim=-1)                 # cumulative log-forget

    # intra-chunk decay matrix: D[l,s] = csf[l]-csf[s]+li[s] for l>=s
    decay = _segsum(lf) + li[..., None, :]         # (B,H,Nc,Q,Q)
    m_intra = decay.amax(-1)                       # (B,H,Nc,Q) finite (diag)

    if state is None:
        C = torch.zeros((bs, h, d, d), dtype=torch.float32, device=q.device)
        n = torch.zeros((bs, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((bs, h), -1e30, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]

    # per-chunk end states (log-weight of position s into the chunk end)
    dec_state = csf[..., -1:] - csf + li           # (B,H,Nc,Q)
    chunk_tot = csf[..., -1]                       # (B,H,Nc)
    m_state = dec_state.amax(-1)                   # (B,H,Nc)
    w_s = torch.exp(dec_state - m_state[..., None]).permute(0, 2, 3, 1)
    kw = kr * w_s[..., None]                       # (B,Nc,Q,H,D)
    Cc = torch.einsum("bcshd,bcshe->bchde", kw, vr)   # (B,Nc,H,D,D)
    ncs = kw.sum(2)                                # (B,Nc,H,D)

    # the reference's lax.scan over chunks: each chunk starts from the
    # state before it (Cp, np_, mp)
    Cp, np_, mp = [], [], []
    for i in range(nc):
        Cp.append(C)
        np_.append(n)
        mp.append(m)
        tot, mi = chunk_tot[:, :, i], m_state[:, :, i]
        m_new = torch.maximum(m + tot, mi)
        a1 = torch.exp(m + tot - m_new)
        a2 = torch.exp(mi - m_new)
        C = C * a1[..., None, None] + Cc[:, i] * a2[..., None, None]
        n = n * a1[..., None] + ncs[:, i] * a2[..., None]
        m = m_new
    Cp = torch.stack(Cp)                           # (Nc,B,H,D,D)
    np_ = torch.stack(np_)                         # (Nc,B,H,D)
    mp = torch.stack(mp)                           # (Nc,B,H)

    # combine intra + inter contributions
    m_inter = csf + mp.permute(1, 2, 0)[..., None]     # (B,H,Nc,Q)
    m_tot = torch.maximum(m_intra, m_inter)
    w_intra = torch.exp(decay - m_tot[..., None])  # (B,H,Nc,Q,Q)
    w_inter = torch.exp(m_inter - m_tot).permute(0, 2, 3, 1)  # (B,Nc,Q,H)
    scores = torch.einsum("bclhd,bcshd->bhcls", qr, kr) * w_intra
    y_intra = torch.einsum("bhcls,bcshe->bclhe", scores, vr)
    # "bclhd,cbhde,bclh->bclhe" and "bclhd,cbhd,bclh->bclh": q with the
    # carried state first, then the weight, as XLA contracts them
    y_inter = torch.einsum("bclhd,cbhde->bclhe", qr, Cp) * w_inter[..., None]
    qn = scores.sum(-1).permute(0, 2, 3, 1) + torch.einsum(
        "bclhd,cbhd->bclh", qr, np_) * w_inter
    y = (y_intra + y_inter) / torch.maximum(
        qn.abs(), torch.exp(-m_tot.permute(0, 2, 3, 1)))[..., None]
    return y.reshape(bs, s, h, d), {"C": C, "n": n, "m": m}


def mlstm_apply(p, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[Dict] = None, chunk: int = 256):
    """x: (B,S,D); state: {'C': (B,H,dk,dk), 'n': (B,H,dk), 'm': (B,H)},
    f32.  Returns (y, new_state).  With a state and S == 1 the step is
    the recurrence (decode, or a one-token prefill chunk); otherwise the
    chunked form continues from the state.  ``new_state`` is None
    without a state."""
    bs, s, _ = x.shape
    h = cfg.num_heads
    d_inner = mlstm_inner(cfg)
    dk = d_inner // h
    up = dense(x, p["up"], cfg.matmul_mode)
    xi, zg = torch.split(up, d_inner, dim=-1)
    xh = xi.reshape(bs, s, h, dk)
    q, k, v = (torch.einsum("bshd,hde->bshe", xh, p[w].to(xh.dtype)).to(
        torch.float32) for w in ("wq", "wk", "wv"))
    log_i = dense(xi, p["wi"], "bf16").to(torch.float32)   # pre-activation
    log_f = _log_sigmoid(dense(xi, p["wf"], "bf16").to(torch.float32))

    if state is not None and s == 1:
        # recurrent step
        C, n, m = state["C"], state["n"], state["m"]
        li, lf = log_i[:, 0], log_f[:, 0]
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)
        f_ = torch.exp(lf + m - m_new)
        ks = k[:, 0] / math.sqrt(dk)
        kv = ks[..., :, None] * v[:, 0, :, None, :]    # (B,H,dk,dk)
        C_new = C * f_[..., None, None] + kv * i_[..., None, None]
        n_new = n * f_[..., None] + ks * i_[..., None]
        num = torch.einsum("bhd,bhde->bhe", q[:, 0], C_new)
        den = torch.einsum("bhd,bhd->bh", q[:, 0], n_new).abs()
        y = (num / torch.maximum(den, torch.exp(-m_new))[..., None])[:, None]
        new_state = {"C": C_new, "n": n_new, "m": m_new}
    else:
        y, new_state = _mlstm_chunked(q, k, v, log_i, log_f, chunk, state)
        if state is None:
            new_state = None
    y = y.reshape(bs, s, d_inner)
    y = rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    y = y * activation(zg.to(y.dtype), "silu")
    return dense(y, p["down"], cfg.matmul_mode), new_state


def mlstm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    """One mLSTM layer's recurrent state: {leaf: (shape, dtype)}."""
    h = cfg.num_heads
    dk = mlstm_inner(cfg) // h
    return {"C": ((batch, h, dk, dk), torch.float32),
            "n": ((batch, h, dk), torch.float32),
            "m": ((batch, h), torch.float32)}


def slstm_defs(cfg: ModelConfig, dtype=torch.bfloat16):
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    return {
        "wx": linear_def(d, 4 * d, "d_model", "ffn", dtype),   # i,f,z,o
        "r": ParamDef((4, h, hd, hd), (None, "heads", None, None), dtype),
        "norm": ParamDef((d,), (None,), torch.float32, "zeros"),
        "wo_proj": linear_def(d, d, "d_model", "d_model", dtype),
    }


def slstm_apply(p, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[Dict] = None):
    """Sequential sLSTM.  x: (B,S,D); state: {'c','n','h'} each (B,H,hd)
    and 'm' (B,H), f32.  Without a state the start is c = h = m = 0 and
    n = 1.  Returns (y, new_state); ``new_state`` is None without a
    state."""
    bs, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    gx = dense(x, p["wx"], cfg.matmul_mode).to(torch.float32)
    gx = gx.reshape(bs, s, 4, h, hd)
    r = p["r"].to(torch.float32)

    if state is None:
        start = {"c": torch.zeros((bs, h, hd), dtype=torch.float32,
                                  device=x.device),
                 "n": torch.ones((bs, h, hd), dtype=torch.float32,
                                 device=x.device),
                 "h": torch.zeros((bs, h, hd), dtype=torch.float32,
                                  device=x.device),
                 "m": torch.zeros((bs, h), dtype=torch.float32,
                                  device=x.device)}
    else:
        start = state
    y, last = _slstm_scan(gx, r, start)
    y = rms_norm(y.reshape(bs, s, d).to(x.dtype), p["norm"], cfg.norm_eps)
    out = dense(y, p["wo_proj"], cfg.matmul_mode)
    return out, (last if state is not None else None)


def _slstm_scan(gx: torch.Tensor, r: torch.Tensor, state: Dict):
    """The sLSTM recurrence over time (the reference's ``lax.scan``): gx
    (B,S,4,H,hd) the input gates' pre-activations, r (4,H,hd,hd) f32,
    ``state`` {'c','n','h','m'}.  Returns (h of every step (B,S,H,hd),
    the last state)."""
    c, n, hprev, m = state["c"], state["n"], state["h"], state["m"]
    ys = []
    for t in range(gx.shape[1]):
        rec = torch.einsum("ghde,bhd->bghe", r, hprev)     # (B,4,H,hd)
        gi, gf, gz, go = (gx[:, t, i] + rec[:, i] for i in range(4))
        log_i = gi.mean(-1)                        # head-wise stabiliser
        log_f = _log_sigmoid(gf.mean(-1))
        m_new = torch.maximum(log_f + m, log_i)
        i_ = torch.exp(gi - m_new[..., None])
        f_ = torch.exp(_log_sigmoid(gf) + (m - m_new)[..., None])
        z = torch.tanh(gz)
        o = _sigmoid(go)
        c = f_ * c + i_ * z
        n = f_ * n + i_
        hprev = o * c / torch.clamp_min(n.abs(), 1.0)
        m = m_new
        ys.append(hprev)
    return torch.stack(ys, dim=1), {"c": c, "n": n, "h": hprev, "m": m}


def slstm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, tuple]:
    """One sLSTM layer's recurrent state: {leaf: (shape, dtype)}."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    f32 = torch.float32
    return {"c": ((batch, h, hd), f32), "n": ((batch, h, hd), f32),
            "h": ((batch, h, hd), f32), "m": ((batch, h), f32)}
