"""AdamW with configurable moment storage and a warmup-cosine schedule.

The reference's ``repro.optim.optimizer`` on tensor trees (nested dicts,
sorted keys).  The update math is f32 whatever the storage dtypes, with
the reference's float expressions in its order: the clip scale, the bias
corrections, decoupled weight decay on leaves with ``ndim >= 2`` only,
and the new parameter cast back to its own dtype.  Scalars (the step,
the learning rate, the clip scale) are 0-d tensors on the parameters'
device, so a step never waits on the host.  A leaf of more than
``SLICE`` elements is updated a slice at a time: the update is
elementwise, so the bits are the same, and its f32 temporaries stay the
size of a slice (zamba2-2.7b's stacked ``in_proj``, 1.44 G elements,
would otherwise hold ~6 GB a temporary).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


#: elements of a leaf that one pass of the update works on
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # bfloat16 for the big configs


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor): linear warmup, then a
    cosine from ``learning_rate`` down to ``min_lr_ratio`` of it."""
    step = step.to(torch.float32)
    warm = cfg.learning_rate * step / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_opt_state(params, cfg: OptimizerConfig):
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0][1].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's
    f32 sum of squares."""
    total = None
    for _, x in tree_leaves(tree):
        x = x.to(torch.float32)
        sq = torch.sum(x * x)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state, cfg: OptimizerConfig,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: returns (new params, new opt state, {"grad_norm",
    "lr"}).  Nothing is updated in place.  ``gnorm`` is the gradients'
    global norm when they are one rank's pieces of a sharded tree
    (``train_step.mesh_grad_norm``), else ``global_norm(grads)``."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm),
                          cfg.grad_clip / torch.clamp_min(gnorm, 1e-9))
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, sf), sf)
    bc2 = 1 - torch.pow(_f32(b2, sf), sf)

    def upd(p, g, m, v, decay: bool):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * delta
        return (newp.to(p.dtype), m32.to(cfg.moment_dtype),
                v32.to(cfg.moment_dtype))

    def leaf(p, g, m, v):
        n, decay = p.numel(), p.dim() >= 2
        if n <= SLICE:
            return upd(p, g, m, v, decay)
        outs = tuple(torch.empty(p.shape, dtype=dt, device=p.device)
                     for dt in (p.dtype, cfg.moment_dtype, cfg.moment_dtype))
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        for lo in range(0, n, SLICE):
            part = upd(*(t[lo:lo + SLICE] for t in flat), decay)
            for o, r in zip(outs, part):
                o.view(-1)[lo:lo + SLICE].copy_(r)
        return outs

    out = tree_map(leaf, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}
