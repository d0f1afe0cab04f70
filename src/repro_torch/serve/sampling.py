"""Token sampling for the paged engine: greedy only, in this slice.

The reference keys temperature sampling on ``jax.random`` threefry
(``fold_in(fold_in(key(seed), rid), step)``); reproducing those bits in
torch integer ops is the sampling slice's work, so ``temperature > 0``
raises until then.
"""
from __future__ import annotations

import numpy as np
import torch


def check_temperature(temperature: float) -> None:
    if temperature > 0:
        raise NotImplementedError(
            "temperature sampling is ported with the sampling slice "
            "(threefry-keyed, to match the reference bit for bit); use "
            "temperature=0 (greedy)")


def sample_tokens(logits: torch.Tensor, temperature: float) -> np.ndarray:
    """Greedy tokens of a (B, V) batch of logits, one per row (the first
    maximum on ties, as ``jnp.argmax``)."""
    check_temperature(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
