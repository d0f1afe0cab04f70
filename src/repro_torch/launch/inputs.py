"""Input specifications per (architecture x shape), without jax.

``input_specs`` gives every model input of a shape as ``(shape, dtype)``
(the reference's ``ShapeDtypeStruct`` stand-ins, torch dtypes);
``demo_batch`` draws a seeded instance of the same structure.  Both
follow ``repro.launch.inputs`` leaf for leaf: ``demo_batch`` draws from
numpy's ``default_rng(seed)`` in the same order and rounds the same way
(float64 draws to f32, then to bf16), so its arrays equal the
reference's bit for bit.

The modality frontends are stubs, as in the reference: whisper receives
precomputed frame embeddings (B, frames, d_model); paligemma receives
precomputed patch embeddings (B, prefix, d_model).  ``demo_batch`` is
where a whisper training batch gets its frames: the data pipeline's
``batch_at`` makes tokens only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf: (shape, dtype)} of the batch of ``shape`` (a decode shape's
    cache is separate: ``model.cache_spec``)."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if shape.kind == "train":
        out["tokens"] = ((b, s), torch.int32)
        out["labels"] = ((b, s), torch.int32)
        out["loss_mask"] = ((b, s), torch.float32)
    elif shape.kind == "prefill":
        out["tokens"] = ((b, s), torch.int32)
    else:  # decode: one new token against a cache of length s
        out["tokens"] = ((b, 1), torch.int32)
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frames"] = ((b, cfg.encoder_frames, cfg.d_model),
                         torch.bfloat16)
    if cfg.num_prefix_tokens and shape.kind != "decode":
        out["patches"] = ((b, cfg.num_prefix_tokens, cfg.d_model),
                          torch.bfloat16)
    return out


def demo_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded random batch matching ``input_specs``, on ``device``
    (``"cuda"`` unless the CPU is asked for): tokens and labels uniform
    in [0, vocab), a mask of ones, frame and patch embeddings standard
    normal."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (dims, dtype) in input_specs(cfg, shape).items():
        if dtype == torch.int32:
            a = torch.from_numpy(rng.integers(0, cfg.vocab_size, dims,
                                              dtype=np.int32))
        elif k == "loss_mask":
            a = torch.ones(dims, dtype=torch.float32)
        else:
            a = torch.from_numpy(rng.standard_normal(dims).astype(
                np.float32)).to(dtype)
        out[k] = a.to(dev)
    return out
