"""Error-feedback int8 compression: the codec of the checkpoint's
optimizer moments, and of a cross-pod gradient reduction.

The scheme is standard EF-SGD: quantise with a per-leaf scale, keep the
quantisation residual locally, add it back before the next round.

``compress``/``decompress`` work on tensor trees (nested dicts) on any
device.  ``compress_leaf_host``/``decompress_leaf_host`` are their numpy
mirrors for one leaf, with the same op order (max -> maximum -> divide,
round half to even, clip), which ``ckpt.codec`` runs on the background
writer thread; the two paths are bitwise identical, and bitwise the
reference's ``repro.optim.compress``.

``compressed_psum``, the compressed all-reduce over a mesh axis, waits
for ROADMAP Queue 1 item 5c (the rest of the distributed layer).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_map


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_one(g: torch.Tensor, r: torch.Tensor):
    g = g.to(torch.float32) + r
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.to(torch.float32) * scale


def compress(grads, residual) -> Tuple[Any, Any, Any]:
    """-> (int8 payloads, per-leaf scales, new residual)."""
    out = tree_map(_compress_one, grads, residual)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), pick(1), pick(2)


def decompress(q, scales):
    return tree_map(lambda qi, si: qi.to(torch.float32) * si, q, scales)


def compress_leaf_host(arr) -> Tuple[np.ndarray, np.float32, np.ndarray]:
    """Numpy mirror of ``compress`` for ONE leaf: -> (q, scale, residual).

    The residual is exact in f32: for q != 0 the quantisation bounds put
    ``g`` and ``q*scale`` within a factor of two of each other, so the
    subtraction is exact by Sterbenz's lemma, and ``q*scale + residual``
    rebuilds ``g`` bitwise (checked at encode time by ``ckpt.codec``).
    """
    g = np.asarray(arr, np.float32)
    scale = np.float32(
        np.maximum(np.max(np.abs(g)), np.float32(1e-12)) / np.float32(127.0))
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    residual = g - q.astype(np.float32) * scale
    return q, scale, residual


def decompress_leaf_host(q: np.ndarray, scale) -> np.ndarray:
    """Numpy mirror of ``decompress`` for one leaf (f32 output)."""
    return q.astype(np.float32) * np.float32(scale)
