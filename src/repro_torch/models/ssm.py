"""Mamba2 (SSD): the zamba2 backbone's state-space block.

The chunked SSD formulation: quadratic only within a chunk, linear
across chunks, for prefill and training; an O(1)-state recurrence for
decode.  The reference writes it in plain JAX (``repro/models/ssm.py``),
so it is plain torch here: no kernel of its own.  ``in_proj`` and
``out_proj`` go through ``dense``, so in ``bp8_fused`` they are absmax
and the fused BP matmul.

The SSD's multi-operand einsums are written as the pairwise
contractions XLA runs for the reference (the order ``jnp.einsum``'s
path search picks at every chunk shape of the served and tested
paths), each an elementwise product or one contraction.  A contraction
still sums in another order than XLA's, so the outputs agree to f32
rounding, not bit for bit.
"""
from __future__ import annotations

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
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


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
