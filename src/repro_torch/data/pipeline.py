"""Deterministic, shardable synthetic data pipeline (numpy).

The port's own copy of the reference's ``repro.data.pipeline``: the same
batches, bit for bit, for every (seed, step, host slice).

Design goals (mirroring a production loader, scaled to this repo):

  * *Stateless indexing*: batch ``i`` is a pure function of (seed, i), so a
    restarted trainer resumes bit-identically from any step without loader
    state in the checkpoint — the strongest form of data-pipeline fault
    tolerance.
  * *Shardable*: each data-parallel host materialises only its slice
    (``host_slice``); the global batch is defined globally, sliced locally.
  * *Document packing*: synthetic "documents" (Zipf-ish token distribution,
    variable length) are packed into fixed-length rows with EOS separators,
    exercising the same code paths a real tokenised corpus would.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

EOS = 1
BOS = 2
RESERVED = 3  # 0 = pad


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 512


def _doc(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    n = int(rng.integers(cfg.mean_doc_len // 4, cfg.mean_doc_len * 2))
    # Zipf-flavoured synthetic tokens over the real vocab range
    z = rng.zipf(1.3, size=n).astype(np.int64)
    toks = RESERVED + (z % (cfg.vocab_size - RESERVED))
    return np.concatenate([[BOS], toks, [EOS]])


def batch_at(cfg: DataConfig, step: int,
             host_slice: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """The global (or host-sliced) batch for ``step`` — pure function."""
    lo, hi = host_slice or (0, cfg.global_batch)
    rows = []
    for r in range(lo, hi):
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, r]))
        buf = np.empty((0,), np.int64)
        while len(buf) < cfg.seq_len + 1:
            buf = np.concatenate([buf, _doc(rng, cfg)])
        rows.append(buf[: cfg.seq_len + 1])
    arr = np.stack(rows).astype(np.int32)
    tokens, labels = arr[:, :-1], arr[:, 1:]
    return {
        "tokens": tokens,
        "labels": labels,
        "loss_mask": (labels != 0).astype(np.float32),
    }


def iterate(cfg: DataConfig, start_step: int = 0,
            host_slice: Optional[Tuple[int, int]] = None
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, host_slice)
        step += 1
