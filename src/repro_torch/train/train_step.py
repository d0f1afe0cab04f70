"""Train step: micro-batch gradient accumulation + AdamW.

The global batch is split into ``accum`` micro-batches, each one's
gradients (through autograd, with the straight-through gradients of the
BP kernels under ``bp8_fused``) summed into an f32 tree: activation memory
is bounded by one micro-batch.  Per-layer recomputation (``cfg.remat``)
and the chunked cross-entropy keep the peak flat in depth and vocab.

The step's parts run under ``torch.profiler.record_function`` ranges,
``train.forward``, ``train.backward`` (each layer's forward recomputed
in it), ``train.grad_sum`` and ``train.adamw``: a profile of a step
reads its time by part from them.

``TrainPlan.for_shape`` is the reference's planner, plain arithmetic on
the config and the shape, its pipelined branch included.  The pipelined
step itself (``pipeline_stages > 1``) waits for the port's distributed
layer, ``dist/``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import build
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)

NEEDS_DIST = "needs the port's distributed layer (ROADMAP Queue 1 item 5)"


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the pipeline: (S - 1) / (M + S - 1)."""
    if num_stages <= 1:
        return 0.0
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    accum_steps: int           # gradient accumulation steps
    micro_batch: int           # global microbatch size (per accum step)
    pipeline_stages: int = 1   # S: "stage"-axis size (1 = no pipelining)
    pipeline_microbatches: int = 1   # M: microbatches per pipeline flush

    @property
    def bubble(self) -> float:
        """Pipeline idle fraction (S - 1) / (M + S - 1); 0 unpipelined."""
        return bubble_fraction(self.pipeline_stages,
                               self.pipeline_microbatches)

    @staticmethod
    def for_shape(cfg: ModelConfig, shape: ShapeConfig, data_shards: int,
                  target_tokens_per_shard: int = 16_384,
                  act_budget_bytes: float = 6e9,
                  seq_shards: int = 1,
                  pipeline_stages: int = 1,
                  tp_shards: int = 1) -> "TrainPlan":
        """Pick grad accumulation so that the remat-saved layer inputs
        (num_layers x micro_tokens_local x d_model x 2 B / seq_shards) fit
        in ``act_budget_bytes``.

        With ``pipeline_stages`` S > 1, the pipeline microbatches M are
        picked jointly with accumulation against the pipelined memory
        model ``act(M) = (tokens_local / M) * d_model * 2 * (M + S - 1 +
        L/S)`` plus the per-device stage weights ``layer_param_bytes *
        (L / S) / tp_shards``: accum = 1 first, then the smallest M >=
        3(S - 1) that fits, M growing, and accum after it, until the
        model fits or the batch runs out (the reference's rules)."""
        if pipeline_stages <= 1:
            cap = act_budget_bytes * seq_shards / (
                max(1, cfg.num_layers) * cfg.d_model * 2.0)
            target = int(min(target_tokens_per_shard,
                             max(cap, shape.seq_len // 8)))
            per_shard = max(1, shape.global_batch // data_shards)
            micro_per_shard = max(1, target // shape.seq_len)
            accum = max(1, per_shard // micro_per_shard)
            while shape.global_batch % accum:
                accum -= 1
            return TrainPlan(accum_steps=accum,
                             micro_batch=shape.global_batch // accum)

        S = pipeline_stages
        L = max(1, cfg.num_layers)
        gb = shape.global_batch
        ds = max(1, data_shards)
        stage_weight_bytes = (_layer_param_bytes(cfg) * (L / S)
                              / max(1, tp_shards))

        def act_bytes(accum: int, m: int) -> float:
            tokens_local = (gb // accum // ds) * shape.seq_len
            per_micro = tokens_local / m * cfg.d_model * 2.0 / seq_shards
            return per_micro * (m + S - 1 + L / S)

        m_floor = max(1, 3 * (S - 1))
        best = None
        for accum in (a for a in range(1, gb + 1) if gb % a == 0):
            micro = gb // accum
            # a microbatch must still tile the batch-sharding axes
            elig = [m for m in range(1, micro + 1)
                    if micro % m == 0 and (micro // m) % ds == 0]
            if not elig:
                continue
            cand = [m for m in elig if m >= min(m_floor, elig[-1])]
            if best is None:   # fallback: least accum, most microbatches
                best = (accum, (cand or elig)[-1])
            for m in cand:
                if act_bytes(accum, m) + stage_weight_bytes <= act_budget_bytes:
                    return TrainPlan(accum_steps=accum, micro_batch=micro,
                                     pipeline_stages=S,
                                     pipeline_microbatches=m)
        accum, m = best if best else (1, 1)
        return TrainPlan(accum_steps=accum, micro_batch=gb // accum,
                         pipeline_stages=S, pipeline_microbatches=m)


def _layer_param_bytes(cfg: ModelConfig) -> float:
    """bf16 bytes of ONE layer of the pipelined stack (attention + MLP or
    MoE), from the model's schema: the dense first layers run outside
    it, so they are not counted; 0 for a family without a ``layers``
    stack, as the reference's."""
    sch = build(cfg).schema()
    if "layers" not in sch:       # encoder-decoder, hybrid, xlstm: none
        return 0.0
    n = sum(math.prod(d.shape) for _, d in tree_leaves(sch["layers"]))
    return n / max(1, cfg.num_layers - cfg.first_dense_layers) * 2.0


def make_train_step(model, opt_cfg: OptimizerConfig, plan: TrainPlan,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds tensors on the state's device; ``state`` is {"params", "opt"}.
    Every family trains (whisper's batches carry "frames", which the
    split into micro-batches cuts along the batch as every leaf).
    Without a mesh only: a mesh or a pipelined plan waits for ``dist/``."""
    if mesh is not None:
        raise NotImplementedError(f"training on a mesh {NEEDS_DIST}")
    if plan.pipeline_stages > 1:
        raise NotImplementedError(
            f"a pipelined TrainPlan (pipeline_stages > 1) {NEEDS_DIST}")

    def train_step(state, batch):
        params = state["params"]
        accum = plan.accum_steps
        leaves = tree_leaves(params)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
        for i in range(accum):
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))[i]
                     for k, v in batch.items()}
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            with record_function("train.forward"):
                loss, _ = model.loss(live, micro)
            flat = [t for _, t in tree_leaves(live)]
            with record_function("train.backward"):   # recompute included
                grads = torch.autograd.grad(loss, flat)
            with record_function("train.grad_sum"):
                for (_, acc), g in zip(tree_leaves(gsum), grads):
                    acc.add_(g.to(torch.float32))
            lsum = lsum + loss.detach()
        with record_function("train.grad_sum"):
            for _, g in tree_leaves(gsum):   # in place: one f32 tree alive
                g.div_(accum)
        grads = gsum
        loss = lsum / accum
        with record_function("train.adamw"):
            new_params, new_opt, om = adamw_update(params, grads,
                                                   state["opt"], opt_cfg)
        metrics: Dict[str, Any] = {"loss": loss, **om,
                                   "step": new_opt["step"]}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(model, seed: int, opt_cfg: OptimizerConfig, device="cuda"):
    """A fresh train state: the model's seeded parameters (``init_params``)
    and zeroed AdamW moments, on ``device``."""
    params = init_params(model.schema(), seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}
