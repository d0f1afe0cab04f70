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
the config and the shape, its pipelined branch included.

On a mesh (``launch.mesh``) the state is held in pieces
(``dist.tp.param_placements``): the layer stack split over "stage" and
its heads, ffn and experts over "model"; the embedding, head, final norm
and dense first layers whole on every rank.  The AdamW moments follow
their parameters, and are replicated over "data": ZeRO sharding over
"data" (the reference's "train" rules' ``"d_model": "data"``) is left
for a later slice (ROADMAP Queue 1 item 5c).  Each accumulation step is
``DecoderModel.pipeline_loss``: pipelined in ``pipeline_microbatches``
over a stage mesh (per-shard BP scales, as the reference's
``shard_map``), or data and tensor parallel on a stage-free one (global
scales: the unsharded step's function).  The gradient norm for clipping
counts each element once across the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist import tp as mtp
from repro_torch.dist.pipeline import bubble_fraction
from repro_torch.launch.mesh import mesh_axis_size
from repro_torch.models.model import build
from repro_torch.models.params import (_init_leaf, axes_tree, init_params,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.optim.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)

#: what the decoder family's mesh step does not cover yet
NEEDS_NEXT = ("is the decoder family's only so far (ROADMAP Queue 1 item "
              "5c)")


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


def param_placements(model, mesh) -> Any:
    """Placements of ``model``'s params on ``mesh`` (``dist/tp.py``)."""
    stages = mesh_axis_size(mesh, "stage")
    return mtp.param_placements(axes_tree(model.schema()),
                                mtp.plan_stage_tp(model.cfg, mesh),
                                "stage" if stages > 1 else None)


def state_placements(model, mesh) -> Dict[str, Any]:
    """Placements of the train state {"params", "opt": {m, v, step}}."""
    pl = param_placements(model, mesh)
    return {"params": pl, "opt": {"m": pl, "v": pl, "step": ()}}


def state_shapes(model) -> Dict[str, Any]:
    """Whole leaf shapes of the train state."""
    shapes = tree_map(lambda d: d.shape, model.schema())
    return {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                      "step": ()}}


def check_mesh(model, mesh, stages: int) -> None:
    """Refuse what the mesh step does not run: a family other than the
    decoders (the reference's have no ``pipeline_loss``: a stage mesh
    fails there too), or a stage count other than the mesh's."""
    cfg = model.cfg
    if not hasattr(model, "pipeline_loss"):
        what = ("a stage mesh (the reference's model of this family has "
                "no pipeline_loss either)" if mesh_axis_size(mesh, "stage")
                > 1 else "a mesh")
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): training on "
                                  f"{what} {NEEDS_NEXT}")
    if mesh_axis_size(mesh, "stage") != stages:
        raise ValueError(f"the plan pipelines over {stages} stages, the "
                         f"mesh has {dict(mesh.shape)}")


def mesh_device(mesh, device) -> torch.device:
    """The mesh's device, when ``device`` (``resolve_device``: CUDA
    unless "cpu" is asked for) names it; raise when they disagree."""
    want = resolve_device(device)
    if want.type != mesh.device.type or (
            want.index is not None and want.index != mesh.device.index):
        raise ValueError(f"device {str(want)!r} is not the mesh's "
                         f"{str(mesh.device)!r}")
    return mesh.device


def mesh_grad_norm(grads, placements, mesh) -> torch.Tensor:
    """The global gradient norm across the ranks' pieces: a layer piece
    split over "model" counts on its rank, one held whole by every
    "model" rank on the first only, the layers' stage pieces summed over
    "stage"; every other leaf (the same on every rank) once."""
    dev = tree_leaves(grads)[0][1].device
    sq_layers = torch.zeros((), dtype=torch.float32, device=dev)
    sq_rest = torch.zeros((), dtype=torch.float32, device=dev)
    first_model = mesh.index("model") == 0
    for (path, g), (_, pl) in zip(tree_leaves(grads),
                                  tree_leaves(placements)):
        sq = torch.sum(g.to(torch.float32) * g.to(torch.float32))
        if path[0] != "layers":
            sq_rest = sq_rest + sq
        elif first_model or any(e is not None and "model" in (
                (e,) if isinstance(e, str) else e) for e in pl):
            sq_layers = sq_layers + sq
    mesh.all_reduce(sq_layers, ("stage", "model"))
    return torch.sqrt(sq_layers + sq_rest)


def _make_mesh_step(model, opt_cfg: OptimizerConfig, plan: TrainPlan, mesh):
    check_mesh(model, mesh, plan.pipeline_stages)
    M = plan.pipeline_microbatches if plan.pipeline_stages > 1 else 1
    # split the per-microbatch batch over whatever of (pod, data) divides
    # it, as the reference filters its shard_map's batch axes
    sizes, rem, batch_axes = dict(mesh.shape), plan.micro_batch // M, []
    for a in ("pod", "data"):
        if a in sizes and rem % sizes[a] == 0:
            batch_axes.append(a)
            rem //= sizes[a]
    placements = param_placements(model, mesh)

    def train_step(state, batch):
        params = state["params"]
        mesh_device(mesh, tree_leaves(params)[0][1].device)
        accum = plan.accum_steps
        gsum = None
        lsum = torch.zeros((), dtype=torch.float32, device=mesh.device)
        times = []
        for i in range(accum):
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))[i]
                     for k, v in batch.items()}
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            with record_function("train.pipeline"):   # backward included
                loss, metrics, grads = model.pipeline_loss(
                    live, micro, mesh=mesh, num_microbatches=M,
                    batch_axes=tuple(batch_axes))
            times.append(metrics["stage_times"])
            with record_function("train.grad_sum"):
                if gsum is None:
                    gsum = grads
                else:
                    for (_, acc), (_, g) in zip(tree_leaves(gsum),
                                                tree_leaves(grads)):
                        acc.add_(g)
            lsum = lsum + loss.detach()
        with record_function("train.grad_sum"):
            for _, g in tree_leaves(gsum):
                g.div_(accum)
        with record_function("train.adamw"):
            gnorm = mesh_grad_norm(gsum, placements, mesh)
            new_params, new_opt, om = adamw_update(
                params, gsum, state["opt"], opt_cfg, gnorm=gnorm)
        out: Dict[str, Any] = {"loss": lsum / accum, **om,
                               "step": new_opt["step"], "stage_times": times}
        return {"params": new_params, "opt": new_opt}, out

    return train_step


def make_train_step(model, opt_cfg: OptimizerConfig, plan: TrainPlan,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds tensors on the state's device; ``state`` is {"params", "opt"}.
    Every family trains without a mesh (whisper's batches carry "frames",
    which the split into micro-batches cuts along the batch as every
    leaf).  On a ``mesh`` the state is this rank's pieces
    (``init_state(mesh=)``), the batch whole on every rank, and a
    pipelined plan (``pipeline_stages`` > 1) needs as many stages on
    the mesh, and runs the 1F1B schedule.  The state must lie on the
    mesh's device."""
    if mesh is not None or plan.pipeline_stages > 1:
        if mesh is None:
            raise ValueError("a pipelined TrainPlan (pipeline_stages > 1) "
                             "needs a mesh with a 'stage' axis")
        return _make_mesh_step(model, opt_cfg, plan, mesh)

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


def init_state(model, seed: int, opt_cfg: OptimizerConfig, device="cuda",
               mesh=None):
    """A fresh train state: the model's seeded parameters (``init_params``)
    and zeroed AdamW moments, on ``device``.  On a ``mesh``, this rank's
    pieces of them: every leaf is drawn whole in ``init_params``' order
    (the same values as without a mesh) and cut, one at a time."""
    if mesh is None:
        params = init_params(model.schema(), seed=seed, device=device)
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        pieces = [shd.local_shard(_init_leaf(d, gen, dev), pl, mesh).clone()
                  for (_, d), (_, pl) in zip(
                      tree_leaves(model.schema()),
                      tree_leaves(param_placements(model, mesh)))]
        params = tree_unflatten(model.schema(), pieces)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def shard_state(state, model, mesh, device):
    """This rank's pieces of a whole train state (a restored checkpoint),
    on ``device``."""
    pl = state_placements(model, mesh)
    return tree_map(lambda t, p: shd.local_shard(t, p, mesh).to(
        device).clone() if p else t.to(device), state, pl)


def gather_state(state, model, mesh, keep: bool):
    """The whole train state from every rank's pieces, one leaf at a time,
    on the mesh's first rank (a collective: every rank calls it); returned
    where ``keep`` (that rank only), else None."""
    def one(t, p, shape):
        whole = shd.gather(t, p, mesh, shape, to_lead=True) if p else t
        return whole if keep else None

    out = tree_map(one, state, state_placements(model, mesh),
                   state_shapes(model))
    return out if keep else None
