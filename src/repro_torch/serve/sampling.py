"""Counter-based token sampling, shared by both serving engines.

A live row's token at output step *t* of request *rid* is
``argmax(gumbel(key) + logits / T)`` in f32, with
``key = fold_in(fold_in(key(seed), rid), step)``: a pure function of the
request's own logits and identity, so which slot it lands in and which
neighbours share its batch cannot perturb it.  This is the reference's
``jax.random.categorical`` (``repro/serve/sampling.py``) reproduced bit
for bit in torch integer ops, on whatever device the logits live:

* threefry2x32 (20 rounds, Random123) over 32-bit words held in int64 and
  masked with ``0xFFFFFFFF`` after each add and each rotate (torch has no
  full uint32 arithmetic on CUDA);
* ``key(seed)`` is the word pair ``(0, seed mod 2^32)`` and
  ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* the 32-bit random bits of a (V,) draw come in one of jax's two layouts:
  ``partitionable=True`` (jax's ``jax_threefry_partitionable``, the
  default from jax 0.5) hashes the counter pair ``(0, i)`` and xors the
  two output words; ``False`` (the original layout) hashes the counters
  ``0 .. V-1`` split into two halves and concatenates the outputs.  A
  program cannot read jax's setting, so the caller names the layout;
* the uniform is ``(bits >> 9 | 0x3F800000)`` read as f32, minus 1,
  ``* (1 - tiny) + tiny``, then ``max(tiny, .)``; the gumbel noise is
  ``-log(-log(u))`` (jax's ``mode="low"``), all in f32.

``log`` is the one step that is not exact arithmetic: torch's CPU and CUDA
``log`` and XLA's may differ in the last bit, so the noise agrees within
an ulp or two and the tokens agree unless two scores tie that closely.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _word(value: int, what: str, lo: int = 0) -> int:
    if not lo <= value <= MASK:
        raise ValueError(f"{what} {value} is out of range [{lo}, {MASK}]")
    return value & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors of 32-bit words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ (((x2 << r) & MASK) | (x2 >> (32 - r)))
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def seed_key(seed: int, n: int = 1, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s words, one row per draw: (n, 2) int64."""
    key = torch.zeros((n, 2), dtype=torch.int64, device=device)
    key[:, 1] = _word(seed, "seed", -(1 << 31))
    return key


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``key`` (n, 2), ``data`` (n,)
    32-bit words; returns the (n, 2) folded keys."""
    y1, y2 = threefry2x32(key[:, 0], key[:, 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=1)


def random_bits(key: torch.Tensor, vocab: int,
                partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bits(key, (vocab,))`` for each of the (n, 2) keys:
    (n, vocab) int64 holding uint32 words."""
    k1, k2 = key[:, :1], key[:, 1:]
    iota = torch.arange(vocab, dtype=torch.int64, device=key.device)
    if partitionable:
        y1, y2 = threefry2x32(k1, k2, torch.zeros_like(iota)[None],
                              iota[None])
        return y1 ^ y2
    half = (vocab + 1) // 2
    counts = torch.zeros(2 * half, dtype=torch.int64, device=key.device)
    counts[:vocab] = iota
    y1, y2 = threefry2x32(k1, k2, counts[None, :half], counts[None, half:])
    return torch.cat([y1, y2], dim=1)[:, :vocab]


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` in f32 from its bits."""
    one = torch.ones((), dtype=torch.float32, device=bits.device)
    tiny = torch.full((), _TINY, dtype=torch.float32, device=bits.device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.maximum(tiny, (floats - one) * (one - tiny) + tiny)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """jax's ``mode="low"`` gumbel noise of its uniforms, f32."""
    return -torch.log(-torch.log(u))


def row_keys(seed: int, rows: Sequence[Tuple[int, int]],
             device) -> torch.Tensor:
    """``fold_in(fold_in(key(seed), rid), step)`` for each (rid, step)."""
    words = torch.tensor([[_word(rid, "rid"), _word(step, "step")]
                          for rid, step in rows], dtype=torch.int64,
                         device=device)
    key = seed_key(seed, len(rows), device)
    return fold_in(fold_in(key, words[:, 0]), words[:, 1])


def sample_tokens(logits: torch.Tensor, rows: Sequence[Optional[tuple]], *,
                  seed: int, temperature: float,
                  partitionable: bool = True) -> np.ndarray:
    """Per-row sampling for a (B, V) batch of logits, as (B,) int32.

    ``rows[i]`` is ``(rid, step)`` for a live row, or ``None`` for a dead
    or padding row, which draws no randomness and gets the argmax, a
    placeholder the caller discards.  ``temperature <= 0`` is the argmax
    (the first maximum) of every row.  The live rows are drawn in one
    batched pass, one key each, and only the B tokens reach the host."""
    tokens = torch.argmax(logits, dim=-1)
    live = [i for i, r in enumerate(rows) if r is not None]
    if temperature > 0 and live:
        idx = torch.tensor(live, dtype=torch.int64, device=logits.device)
        keys = row_keys(seed, [rows[i] for i in live], logits.device)
        noise = gumbel(uniform(random_bits(keys, logits.shape[-1],
                                           partitionable)))
        temp = torch.full((), temperature, dtype=torch.float32,
                          device=logits.device)
        scaled = logits.index_select(0, idx).to(torch.float32) / temp
        tokens.index_copy_(0, idx, torch.argmax(noise + scaled, dim=-1))
    return tokens.to(torch.int32).cpu().numpy()


def sample_row(logits_row: torch.Tensor, *, seed: int, rid: int, step: int,
               temperature: float, partitionable: bool = True) -> int:
    """Sample one token for request ``rid`` at output step ``step``."""
    return int(sample_tokens(logits_row[None], [(rid, step)], seed=seed,
                             temperature=temperature,
                             partitionable=partitionable)[0])
