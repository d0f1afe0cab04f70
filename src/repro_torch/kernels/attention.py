"""BP8 KV quantisation and the fused decode-attention kernel's wrapper.

The KV cache stores int8 sign*level codes plus one f32 scale per
(token, kv-head), so decode streams 1 byte per cached element and
dequantises inside the kernel (``csrc/decode_attention.cu``, replacing
the Pallas ``bp8_decode_attention``).  ``bp8_decode_attention_ref`` is
its plain version: dequantise the whole cache, mask, softmax, weighted
sum.  The kernel splits the cache into runs of ``split_tokens`` tokens
and merges the splits' partial softmaxes;
``bp8_decode_attention_split_ref`` is that schedule written as tensor
code.  The kernel matches both within 1e-5 (the softmax is reassociated
over the splits).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.bp import NUM_LEVELS
from repro_torch.kernels.build import launch, on_cuda, require, stream

NEG_INF = -1e30
BIG_WINDOW = 1 << 30
_TINY = float(torch.finfo(torch.float32).tiny)
SPLIT_MAX = 128             # tokens per split: one per thread of a block
SPLIT_SMEM = 64 * 1024      # shared memory a split's block may take
BLOCKS_PER_SM = 4           # grid target: this many blocks per SM


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KH, D) real -> (int8 sign*level codes, (B, S, KH) f32 scale);
    the scale is max-|x| over the head dimension."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1), _TINY)
    lvl = torch.clamp(torch.round(xf.abs() / scale[..., None] * 10.0), 0.0,
                      float(NUM_LEVELS - 1))
    return (torch.sign(xf) * lvl).to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Invert ``quantize_kv``: value = codes / 10 * scale."""
    return codes.to(dtype) / 10.0 * scale[..., None].to(dtype)


def bp8_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, kv_pos,
                             q_pos, window: Optional[int], *, softcap=None,
                             causal: bool = True) -> torch.Tensor:
    """Plain version: dequantise the whole cache, then masked softmax."""
    k = dequantize_kv(k_codes, k_scale)                    # (B, S, KH, D)
    v = dequantize_kv(v_codes, v_scale)
    scores = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    window = BIG_WINDOW if window is None else int(window)
    qp = q_pos.to(torch.int32)[:, None]                    # (B, 1)
    kp = kv_pos.to(torch.int32)
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    ok = ok & (qp - kp < window)
    scores = torch.where(ok[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=scores.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bshv->bhgv", p, v)


def _split_smem(g: int, d: int, split: int) -> int:
    """Bytes of shared memory of one split's block (csrc: q, K padded to
    D + 1, V, scores, the table of code / 10)."""
    return 4 * (g * d + split * (d + 1) + split * d + g * split + 256)


def split_tokens(s: int, rows: int, g: int, d: int, sms: int = 132) -> int:
    """Tokens per split: 32, 64 or 128 (a block's threads share its tokens
    evenly), the least that keeps the grid within ``BLOCKS_PER_SM`` blocks
    per SM over the ``rows`` (row x kv-head) pairs, shrunk until its block
    fits ``SPLIT_SMEM``."""
    want = max(1, math.ceil(BLOCKS_PER_SM * sms / max(rows, 1)))
    split = 32
    while split < SPLIT_MAX and math.ceil(max(s, 1) / split) > want:
        split *= 2
    while split > 32 and _split_smem(g, d, split) > SPLIT_SMEM:
        split //= 2
    return split


def bp8_decode_attention_split_ref(q, k_codes, k_scale, v_codes, v_scale,
                                   kv_pos, q_pos, window: Optional[int], *,
                                   softcap=None, causal: bool = True,
                                   split: int = 64) -> torch.Tensor:
    """The kernel's schedule as tensor code: the cache cut into runs of
    ``split`` tokens (the last one partial), a softmax partial
    ``(m, l, acc)`` per run, then the merge ``out = sum acc_i exp(m_i - M)
    / max(sum l_i exp(m_i - M), 1e-30)``.  Masked tokens score -1e30,
    tokens past S -inf."""
    b, kh, g, d = q.shape
    s = k_codes.shape[1]
    n = math.ceil(s / split)
    pad = n * split - s
    k = dequantize_kv(k_codes, k_scale)                    # (B, S, KH, D)
    v = dequantize_kv(v_codes, v_scale)
    scores = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    window = BIG_WINDOW if window is None else int(window)
    qp = q_pos.to(torch.int32)[:, None]
    kp = kv_pos.to(torch.int32)
    ok = (kp >= 0) & (qp - kp < window)
    if causal:
        ok = ok & (kp <= qp)
    scores = torch.where(ok[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=scores.device))
    scores = F.pad(scores, (0, pad), value=-math.inf)
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    sc = scores.reshape(b, kh, g, n, split)
    m = sc.amax(-1)                                        # (B, KH, G, n)
    p = torch.exp(sc - m[..., None])
    l_ = p.sum(-1)
    acc = torch.einsum("bhgnc,bnchv->bhgnv", p,
                       v.reshape(b, n, split, kh, -1))
    mx = m.amax(-1, keepdim=True)
    w = torch.exp(m - mx)
    den = torch.clamp_min((l_ * w).sum(-1), 1e-30)
    return (acc * w[..., None]).sum(-2) / den[..., None]


def bp8_decode_attention(q: torch.Tensor, k_codes: torch.Tensor,
                         k_scale: torch.Tensor, v_codes: torch.Tensor,
                         v_scale: torch.Tensor, kv_pos: torch.Tensor,
                         q_pos: torch.Tensor, window: Optional[int], *,
                         softcap: Optional[float] = None,
                         causal: bool = True) -> torch.Tensor:
    """One decoded token per row over a BP8 cache.

    ``q``: (B, KH, G, D) f32, already scaled by 1/sqrt(D); codes
    (B, S, KH, D) int8; scales (B, S, KH) f32; ``kv_pos`` (B, S) int32
    (-1 = empty slot); ``q_pos`` (B,) int32; ``window`` an int or None.
    Returns (B, KH, G, D) f32.
    """
    args = (q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos)
    if not on_cuda(*args):
        return bp8_decode_attention_ref(*args, window, softcap=softcap,
                                        causal=causal)
    require(q, "q", torch.float32, 4)
    b, kh, g, d = q.shape
    for t, name in ((k_codes, "k_codes"), (v_codes, "v_codes")):
        require(t, name, torch.int8, 4)
        if t.shape[0] != b or t.shape[2:] != (kh, d):
            raise ValueError(f"{name}: {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    s = k_codes.shape[1]
    if v_codes.shape != k_codes.shape:
        raise ValueError("k_codes and v_codes must have one shape")
    for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
        require(t, name, torch.float32, 3)
        if t.shape != (b, s, kh):
            raise ValueError(f"{name}: expected {(b, s, kh)}, got "
                             f"{tuple(t.shape)}")
    require(kv_pos, "kv_pos", torch.int32, 2)
    require(q_pos, "q_pos", torch.int32, 1)
    if kv_pos.shape != (b, s) or q_pos.shape != (b,):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match (B, S)={(b, s)}")
    if g > 16:
        raise ValueError(f"q: at most 16 query heads per kv-head, got {g}")
    out = torch.empty((b, kh, g, d), dtype=torch.float32, device=q.device)
    if b and kh and s:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        split = split_tokens(s, b * kh, g, d, sms)
        parts = b * kh * math.ceil(s / split)
        ws = torch.empty((parts * (g * d + 2 * g),), dtype=torch.float32,
                         device=q.device)
        win = BIG_WINDOW if window is None else int(window)
        launch("decode_attention", q.data_ptr(), k_codes.data_ptr(),
               k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
               kv_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
               ws.data_ptr(), b, s, kh, g, d, split, win,
               float(softcap or 0.0), int(causal), stream())
    return out
