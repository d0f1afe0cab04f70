"""The model families' serving entry points and training losses:
``DecoderModel`` (the decoders), ``EncDecModel`` (whisper: an encoder
over stub frame embeddings, a causal decoder with cross attention),
``HybridModel`` (zamba2: a Mamba2 backbone with one shared attention
block every ``attn_every`` layers, per-group LoRA) and ``XLSTMModel``
(xlstm: groups of mLSTM blocks closed by one sLSTM block, recurrent
state only).

Functional like the reference: parameters are a nested dict of tensors
(layer parameters stacked on a leading ``L`` axis) passed to every call,
and a Python loop over the layers takes the place of ``lax.scan``.
Caches are nested dicts of stacked tensors, updated in place layer by
layer.  The model runs wherever its parameters live; the three serving
entry points run under ``torch.inference_mode()``, and ``loss`` under
autograd, with the reference's recomputation when ``cfg.remat``: each
decoder layer, each whisper decoder layer (not its encoder layers), each
zamba2 Mamba2 layer (not the shared block) and each xlstm mLSTM block
(not the sLSTM block) is run again in the backward.

Sequence parallelism (``dist/seq.py``): under ``sharding.use_rules(mesh,
get_rules("sequence"))`` and ``seq.use_ring(mesh)`` on a mesh with a
"seq" axis of n ranks, a decoder serves on every rank.  Each rank holds
one block of ``ceil(L / n)`` slots of the cache (``cache_spec``);
``prefill`` runs the rank's block of the prompt's rows where the rules
shard "seq" and n divides the prompt (its BP scales reduced over the
ring, its MoE layers routing the gathered sequence), else every row
(the ring then rotates the stats); ``decode_step``'s rows are whole on
every rank and each token is written by the rank whose block holds it;
the logits are computed on one rank of the ring and shared.
Weights stay whole on every ring rank: the preset's folding of
``ffn``/``heads``/``vocab``/``experts`` over "seq" waits for the ZeRO
slice (ROADMAP Queue 1 item 5c), as do the other families, a "model"
axis and chunked prefill under a ring, which refuse.

Tensor-parallel serving (``dist/serving.py``): under
``serving.use_tp_serving(mesh, phase, batch=)`` on a stage-free ("data",
"model") mesh, a decoder's three serving entry points take the whole
batch on every rank and return every row's logits.  Each rank runs its
rows (the rules' "batch" cut) on its pieces of the weights
(``serving.serve_params``) under the rules' TP plan with global BP
scales; its cache holds its rows and the kv heads its q heads read
(``cache_spec``); the embedding lookup and the logits run on its slice of
a vocabulary split over the rules' axes, summed and gathered.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import seq as _seq
from repro_torch.dist import serving as _serving
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (chunked_softmax_xent, dense,
                                       embed_def, embed_lookup, layer_norm,
                                       linear_def, ln_defs, mlp_apply,
                                       mlp_defs, norm_def, rms_norm)
from repro_torch.models.params import (ParamDef, stack, tree_leaves,
                                       tree_map, tree_unflatten)

BIG_WINDOW = 1 << 30  # "no window"


def _served(fn):
    """A serving entry point: refused under a ring or a serving mesh where
    this slice does not serve (``dist.seq.check_serving``: the families
    other than the decoders, and a "model" axis; ``dist.serving.check``:
    the families other than the decoders)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kw):
        _seq.check_serving(self.cfg)
        _serving.check(self.cfg)
        return fn(self, *args, **kw)
    return wrapper


def _decoder_layer_defs(cfg: ModelConfig, moe: bool = False):
    d = {"ln1": norm_def(cfg.d_model), "ln2": norm_def(cfg.d_model),
         "attn": (attn.mla_defs(cfg) if cfg.attention_type == "mla"
                  else attn.gqa_defs(cfg))}
    if moe:
        d["moe"] = moe_mod.moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_gated)
    if cfg.local_global_pattern:  # gemma3 also post-norms
        d["post_ln1"] = norm_def(cfg.d_model)
        d["post_ln2"] = norm_def(cfg.d_model)
    return d


def _layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention windows (BIG_WINDOW = full attention); with a
    ``local_global_pattern`` of N, every (N+1)-th layer is global."""
    w = np.full((cfg.num_layers,), cfg.window_size or BIG_WINDOW, np.int64)
    if cfg.local_global_pattern:
        w[cfg.local_global_pattern::cfg.local_global_pattern + 1] = \
            BIG_WINDOW
    return w


def _decoder_layer_apply(p, cfg: ModelConfig, x, positions, *, window,
                         cache=None, prefix_len=None, append=False):
    """Returns (x, cache, aux): aux is the MoE layer's auxiliary loss, or
    None for a dense layer."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention_type == "mla":
        a, cache = attn.mla_apply(p["attn"], cfg, h, positions, cache=cache,
                                  window=window, append=append)
    else:
        a, cache = attn.gqa_apply(p["attn"], cfg, h, positions,
                                  window=window, cache=cache,
                                  prefix_len=prefix_len, append=append)
    if "post_ln1" in p:
        a = rms_norm(a, p["post_ln1"], cfg.norm_eps)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if "moe" in p:
        ring = _seq.current_ring()
        if ring is not None and ring.rows is not None:
            # rows sharded over a ring: routing's capacity counts every
            # row of the call, so the layer routes the whole sequence
            h = _seq.gather_rows(h)
            with _seq.whole_rows():
                r = moe_mod.moe_apply(p["moe"], cfg, h)
            r["out"] = _seq.row_block(r["out"])
        else:
            r = moe_mod.moe_apply(p["moe"], cfg, h)
        m, aux = r["out"], r["aux_loss"]
    else:
        m = mlp_apply(p["mlp"], h, cfg.act, cfg.mlp_gated, cfg.matmul_mode)
    if "post_ln2" in p:
        m = rms_norm(m, p["post_ln2"], cfg.norm_eps)
    return x + m, cache, aux


def _init_cache(spec, device):
    """A cache of ``spec`` ({leaf: (shape, dtype)}): zeros, and
    ``pos = -1`` (empty) in every int32 leaf."""
    return tree_map(
        lambda sd: (torch.full(sd[0], -1, dtype=sd[1], device=device)
                    if sd[1] == torch.int32 else
                    torch.zeros(sd[0], dtype=sd[1], device=device)), spec)


def _stacked(spec: Dict[str, tuple], *lead: int) -> Dict[str, tuple]:
    """``spec`` with leading stack dimensions ``lead`` on every leaf."""
    return {k: (tuple(lead) + shape, dtype)
            for k, (shape, dtype) in spec.items()}


def _unstacked(stacked, n: int):
    """The ``n`` layers of a stacked tree, each a tree of views: one
    ``unbind`` a leaf, so that under autograd the layers' gradients are
    stacked in one pass (indexing layer by layer would add each into a
    zero tensor of the whole stack)."""
    parts = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def _xent_loss(h, embed, batch):
    """The reference's tied-embedding loss of the encoder-decoder, hybrid
    and xlstm families: mean next-token cross-entropy over the mask (all
    ones without ``loss_mask``); returns (loss, {"loss"})."""
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    total, denom = chunked_softmax_xent(h, embed, labels, mask)
    loss = total / torch.clamp_min(denom, 1.0)
    return loss, {"loss": loss}


def _run_layer(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` in a training forward: recomputed in the backward
    when ``cfg.remat`` (the reference's ``jax.checkpoint``)."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class _TiedLogits:
    """``_logits``: f32 logits against the tied embedding (whisper, zamba2
    and xlstm always tie it)."""

    def _logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V)."""
        return torch.matmul(h.to(torch.float32),
                            params["embed"].to(torch.float32).T)


def _decode_positions(pos, b: int, device) -> torch.Tensor:
    """(B, 1) positions from a scalar (lock-step) or (B,) (paged) pos."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() == 1:
        return pos.reshape(b, 1)
    return pos.reshape(1, 1).expand(b, 1)


@dataclasses.dataclass
class DecoderModel:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family != "decoder" or cfg.attention_type not in ("gqa",
                                                                 "mla"):
            raise NotImplementedError(
                f"{cfg.name}: only GQA and MLA decoders are ported so far")
        attn.kv_quantized(cfg)            # validates kv_quant

    # ---------------- schema / caches ----------------
    def schema(self):
        cfg = self.cfg
        sch: Dict[str, Any] = {
            "embed": embed_def(cfg.vocab_size, cfg.d_model),
            "final_norm": norm_def(cfg.d_model),
            "layers": stack(_decoder_layer_defs(cfg, cfg.num_experts > 0),
                            cfg.num_layers - cfg.first_dense_layers),
        }
        if cfg.first_dense_layers:
            sch["dense_layers"] = stack(_decoder_layer_defs(cfg),
                                        cfg.first_dense_layers)
        if not cfg.tie_embeddings:
            sch["head"] = linear_def(cfg.d_model, cfg.vocab_size,
                                     "d_model", "vocab")
        return sch

    def _stacks(self):
        """(name, layers) of the stacks in the order they run: the dense
        first layers (deepseek-v2), then the rest."""
        cfg = self.cfg
        n_dense = cfg.first_dense_layers
        return ([("dense_layers", n_dense)] if n_dense else []) + [
            ("layers", cfg.num_layers - n_dense)]

    def cache_spec(self, batch: int, length: int):
        """{stack: {leaf: ((L, batch, length, ...), dtype)}}.  With
        ``cfg.ring_cache`` a layer keeps ``min(length, window)`` slots,
        which needs every layer windowed (a uniform window).  Under a ring
        whose rules shard "kv_seq" (``dist.seq.kv_ring``) a rank holds one
        block of ``ceil(length / n)`` slots of a cache padded to n such
        blocks.  On a serving mesh (``dist.serving``) ``batch`` is the
        whole batch and a rank holds its rows and the kv heads its q heads
        read (``serving.local_kv_heads``; MLA's latent whole)."""
        cfg = self.cfg
        if cfg.ring_cache and (not cfg.window_size
                               or cfg.local_global_pattern):
            raise ValueError(f"{cfg.name}: a ring cache needs every layer "
                             f"windowed (window_size set and no "
                             f"local_global_pattern)")
        lay = _seq.kv_ring(batch)
        if lay is not None:
            if cfg.ring_cache:
                raise NotImplementedError(
                    f"{cfg.name}: a ring-buffer cache over a seq-sharded "
                    f"ring {_seq.NEEDS_NEXT}")
            length = lay.block(length)[1]
        kv_heads = None
        sv = _serving.current_serving()
        if sv is not None:
            _serving.check(cfg, batch)
            lo, hi = sv.rows(batch)
            batch = hi - lo
            kv_heads = sv.kv_heads(cfg)[1]
        one = attn.kv_cache_spec(cfg, batch, length, ring=cfg.ring_cache,
                                 kv_heads=kv_heads)
        return {name: {k: ((n,) + shape, dtype)
                       for k, (shape, dtype) in one.items()}
                for name, n in self._stacks()}

    def cache_axes(self):
        one = attn.kv_cache_axes(self.cfg)
        return {name: one for name, _ in self._stacks()}

    @_served
    def init_cache(self, batch: int, length: int, device):
        """Empty cache: zeros, and ``pos = -1`` (empty) everywhere; on a
        serving mesh this rank's piece, marked with its layout."""
        cache = _init_cache(self.cache_spec(batch, length), device)
        sv = _serving.current_serving()
        if sv is not None:
            _serving.mark_cache(cache, sv.cache_layout(self.cfg, batch))
        return cache

    # ---------------- forward over the stack ----------------
    def _stack(self, params, x, positions, caches, prefix_len, mode: str):
        """Runs the stacks in turn; returns (h, caches, aux): aux sums the
        MoE layers' auxiliary losses (None without MoE layers)."""
        cfg = self.cfg
        windows = _layer_windows(cfg)
        aux_total = None

        def layer_fn(x, lp, window):
            y, _, aux = _decoder_layer_apply(lp, cfg, x, positions,
                                             window=window,
                                             prefix_len=prefix_len)
            return y, aux

        i0 = 0
        for name, n in self._stacks():
            for i, lp in enumerate(_unstacked(params[name], n)):
                window = int(windows[i0 + i])
                if mode == "train":
                    x, aux = _run_layer(cfg, layer_fn, x, lp, window)
                else:
                    lc = (None if caches is None else
                          {k: v[i] for k, v in caches[name].items()})
                    x, _, aux = _decoder_layer_apply(
                        lp, cfg, x, positions, window=window, cache=lc,
                        prefix_len=prefix_len,
                        append=mode == "prefill_chunk")
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
            i0 += n
        return rms_norm(x, params["final_norm"], cfg.norm_eps), caches, \
            aux_total

    def _scaled_embed(self) -> bool:
        """Token embeddings are scaled by sqrt(d_model) for gemma3 and
        paligemma, as the reference decides."""
        cfg = self.cfg
        return cfg.local_global_pattern > 0 or cfg.num_prefix_tokens > 0

    def _embed_in(self, params, batch):
        """Token embeddings, and for paligemma the batch's patch
        embeddings (the stub vision tower's output) prepended unscaled."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.num_prefix_tokens and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _prefix(self, b: int, device):
        """(B,) prefix lengths for the mask, or None without a prefix."""
        n = self.cfg.num_prefix_tokens
        return (torch.full((b,), n, dtype=torch.int32, device=device)
                if n else None)

    def _vocab(self, params):
        """(mesh, axes) of the vocabulary's split on a serving mesh, or
        None where every rank holds it whole."""
        sv = _serving.current_serving()
        axes = () if sv is None else sv.vocab_axes(self.cfg)
        return (sv.mesh, axes) if axes else None

    def _embed(self, params, tokens):
        """Token embeddings; on a serving mesh that splits the vocabulary,
        each rank looks up its slice and the ranks sum."""
        return embed_lookup(params["embed"], tokens,
                            scale=self._scaled_embed(),
                            split=self._vocab(params))

    def _logits(self, params, h):
        """f32 logits; on a serving mesh that splits the vocabulary, each
        rank computes its columns from its slice (no rank casts more than
        its slice of the head to f32) and the ranks gather them."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        logits = torch.matmul(h.to(torch.float32), w.to(torch.float32))
        if self.cfg.logit_softcap:
            sc = self.cfg.logit_softcap
            logits = torch.tanh(logits / sc) * sc
        split = self._vocab(params)
        if split is not None:
            mesh, axes = split
            logits = torch.cat(mesh.all_gather(logits.contiguous(), axes),
                               -1)
        return logits

    # ---------------- entry points ----------------
    def loss(self, params, batch):
        """Mean next-token cross-entropy over ``batch`` ("tokens" and
        "labels" (B, S), optional "loss_mask"); returns (loss, metrics).
        Runs under autograd; each layer is recomputed in the backward
        when ``cfg.remat``."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        h, _, aux = self._stack(params, x, positions, None,
                                self._prefix(b, x.device), "train")
        if cfg.num_prefix_tokens:
            h = h[:, cfg.num_prefix_tokens:]
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        total, denom = chunked_softmax_xent(
            h, params["embed"] if cfg.tie_embeddings else params["head"].T,
            labels, mask, softcap=cfg.logit_softcap)
        loss = total / torch.clamp_min(denom, 1.0)
        if cfg.num_experts:
            loss = loss + 0.01 * aux / cfg.num_layers
        else:              # no experts: the reference's f32 zero
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "aux_loss": aux}

    def pipeline_loss(self, params, batch, *, mesh, num_microbatches: int = 1,
                      batch_axes: Tuple[str, ...] = ("data",),
                      schedule: str = "1f1b"):
        """The train loss on ``mesh`` and its gradients: returns ``(loss,
        metrics, grads)``, the loss and metrics whole on every rank, the
        gradients f32 in the shapes of this rank's ``params`` pieces
        (``dist.tp.param_placements``), already summed over the ranks that
        hold the same piece.  Torch has no autograd across ranks, so this
        runs the backward too (``dist.pipeline.pipeline_grads``).

        The layer stack runs over the "stage" axis in ``num_microbatches``
        microbatches in ``schedule``'s order; a depth the stage count does
        not divide leaves the last stage fewer layers (the reference pads
        it with identity layers).  Each stage runs its layers with their
        windows, each layer recomputed in the backward when ``cfg.remat``.
        The embedding and the dense first layers (on stage 0, over the
        whole batch) and the final norm and chunked cross-entropy (on the
        last stage) stay outside the pipeline, as the reference's do.
        The per-microbatch batch splits over ``batch_axes`` (row-major:
        microbatch m, then the data shard, as the reference's reshape and
        ``shard_map`` split it); the loss is normalised by the whole
        batch's mask.  Tensor parallelism over "model" runs inside the
        stages under ``plan_stage_tp(cfg, mesh)``: in the per-shard scale
        regime on a stage mesh, in the global one on a mesh without
        stages (``dist.tp``).  The MoE aux loss is averaged over the
        (microbatch x data shard) chunks, the reference's redefinition:
        dense stacks equal ``loss`` up to float reassociation."""
        from repro_torch.dist import pipeline as pp
        from repro_torch.dist import tp as mtp
        cfg = self.cfg
        if cfg.num_prefix_tokens:
            raise ValueError("the pipelined loss takes no prefix tokens")
        S, stage = mesh.size("stage"), mesh.index("stage")
        exact = S == 1
        batch_axes = tuple(a for a in batch_axes if a in mesh.shape)
        plan = mtp.plan_stage_tp(cfg, mesh)
        M = num_microbatches
        tokens = batch["tokens"]
        b, s = tokens.shape
        D, di = mesh.size(batch_axes), mesh.index(batch_axes)
        if b % M or (b // M) % D:
            raise ValueError(f"batch {b} does not split into {M} "
                             f"microbatches of {D} data shards")
        bm, bl = b // M, b // M // D

        def rows(m: int) -> slice:
            return slice(m * bm + di * bl, m * bm + (di + 1) * bl)

        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        denom = torch.clamp_min(mask.sum(), 1.0)
        windows = _layer_windows(cfg)
        n_dense = cfg.first_dense_layers
        lo, hi = pp.stage_layers(cfg.num_layers - n_dense, S, stage)
        layers = _unstacked(params["layers"], hi - lo)
        first, last = stage == 0, stage == S - 1
        leaves = tree_leaves(params)
        index = {path: i for i, (path, _) in enumerate(leaves)}
        grads = [None] * len(leaves)
        scales = (mtp.global_scales(mesh, batch_axes + ("model",))
                  if exact else contextlib.nullcontext())
        with scales:
            x_all = x_det = dx_all = None
            if first:   # the embedding and dense layers: the whole batch
                x_all = self._embed_in(params, batch)
                pos = torch.arange(s, device=x_all.device)[None].expand(b, s)
                for i, lp in enumerate(_unstacked(params.get(
                        "dense_layers", {}), n_dense)):
                    x_all, _ = _run_layer(cfg, self._train_layer, x_all, lp,
                                          int(windows[i]), pos)
                x_det = x_all.detach()
                dx_all = torch.zeros_like(x_det)
            pos = torch.arange(s, device=tokens.device)[None].expand(bl, s)

            def first_fn(m):
                return x_det[rows(m)].detach().requires_grad_()

            def on_input_grad(m, g):
                dx_all[rows(m)] = g

            def stage_fn(a, m):
                aux = None
                for i, lp in enumerate(layers):
                    a, a1 = _run_layer(cfg, self._train_layer, a, lp,
                                       int(windows[n_dense + lo + i]), pos)
                    if a1 is not None:
                        aux = a1 if aux is None else aux + a1
                return a, aux

            def last_fn(y, m):
                h = rms_norm(y, params["final_norm"], cfg.norm_eps)
                total, _ = chunked_softmax_xent(
                    h, params["embed"] if cfg.tie_embeddings
                    else params["head"].T, labels[rows(m)], mask[rows(m)],
                    softcap=cfg.logit_softcap)
                return total / denom

            mine = [i for i, (path, _) in enumerate(leaves)
                    if path[0] == "layers" or (last and path[0] in (
                        "final_norm", "head", "embed"))]
            chunks = M * D
            with mtp.use_stage_tp(plan, mesh if plan else None,
                                  exact=exact):
                got, loss, aux, times = pp.pipeline_grads(
                    stage_fn, mesh, M, inputs=[leaves[i][1] for i in mine],
                    act_shape=(bl, s, cfg.d_model),
                    act_dtype=leaves[index[("embed",)]][1].dtype,
                    first_fn=first_fn, last_fn=last_fn,
                    on_input_grad=on_input_grad,
                    aux_coef=(0.01 / cfg.num_layers / chunks
                              if cfg.num_experts else 0.0),
                    schedule=schedule)
            for i, g in zip(mine, got):
                grads[i] = g
            if first:   # the embedding's and dense layers' backward, once
                outer = [i for i, (path, _) in enumerate(leaves)
                         if path[0] in ("embed", "dense_layers")]
                got = torch.autograd.grad(x_all, [leaves[i][1]
                                                  for i in outer], dx_all,
                                          allow_unused=True)
                for i, g in zip(outer, got):
                    if g is not None:
                        g = g.to(torch.float32)
                        grads[i] = g if grads[i] is None else grads[i] + g
        out = []
        for (path, t), g in zip(leaves, grads):
            g = torch.zeros(t.shape, dtype=torch.float32, device=t.device) \
                if g is None else g
            # a layer piece is one stage's; every other leaf every stage's
            axes = batch_axes if path[0] == "layers" else \
                ("stage",) + batch_axes
            out.append(mesh.all_reduce(g, axes))
        sums = torch.stack([loss, aux])
        mesh.all_reduce(sums, ("stage",) + batch_axes)
        loss, aux = sums[0], sums[1] / chunks
        if cfg.num_experts:
            loss = loss + 0.01 * aux / cfg.num_layers
        metrics = {"loss": loss, "aux_loss": aux, "stage_times": times}
        return loss, metrics, tree_unflatten(params, out)

    def _train_layer(self, x, lp, window: int, positions):
        """One layer of the pipelined loss: (x, aux or None)."""
        y, _, aux = _decoder_layer_apply(lp, self.cfg, x, positions,
                                         window=window)
        return y, aux

    @_served
    @torch.inference_mode()
    def prefill(self, params, batch, cache_len: int):
        """Prefill ``batch["tokens"]`` (B, S) (after ``batch["patches"]``
        (B, prefix, d_model) for paligemma) into a fresh cache of
        ``cache_len`` plus the prefix; returns (last-position logits
        (B, V), cache).  On a serving mesh (``dist.serving``) every rank
        takes the whole batch, runs its rows and returns every row's
        logits; its cache holds its piece."""
        rows = batch["tokens"].shape[0]
        with _serving.call(self, rows, params) as part:
            logits, cache = self._prefill(params, part.cut(batch), cache_len,
                                          rows)
            return part.gather(logits), cache

    def _prefill(self, params, batch, cache_len: int, rows: int):
        """``prefill`` on this rank's rows of a batch of ``rows``."""
        x = self._embed_in(params, batch)
        b, s, _ = x.shape
        cache = self.init_cache(rows, cache_len + self.cfg.num_prefix_tokens,
                                x.device)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        lay = self._row_ring(b, s)
        if lay is None:
            h, cache, _ = self._stack(params, x, positions, cache,
                                      self._prefix(b, x.device), "prefill")
            return self._ring_logits(params, h[:, -1:]), cache
        # rows sharded over the ring: this rank runs its block of the
        # prompt; the last position's row is the ring's last rank's
        lo, c = lay.block(s)
        with _seq.shard_rows(s, lay):
            h, cache, _ = self._stack(params, x[:, lo:lo + c],
                                      positions[:, lo:lo + c], cache,
                                      self._prefix(b, x.device), "prefill")
        return self._ring_logits(params, h[:, -1:], lay.n - 1), cache

    def _ring_logits(self, params, h, owner: int = 0):
        """(B, V) logits of the one-row ``h`` (B, 1, D); under a ring,
        computed on the ring's rank ``owner`` and shared (every rank would
        compute the same; the head's f32 cast is some 5 GB at qwen2-72b's
        width)."""
        if _seq.current_ring() is None:
            return self._logits(params, h)[:, 0]
        return _seq.on_one_rank(lambda: self._logits(params, h)[:, 0],
                                (h.shape[0], self.cfg.vocab_size),
                                torch.float32, h.device, owner)

    def _row_ring(self, b: int, s: int):
        """The ring layout of a prefill's rows (``dist.seq.row_ring``), or
        None when every rank runs every row: also in ``bp8`` and
        ``bp8_lowrank``, whose scales ``dist.tp.global_scales`` does not
        reduce (their rows stay whole and the ring rotates the stats,
        whose output has the same bits)."""
        if self.cfg.matmul_mode in ("bp8", "bp8_lowrank"):
            return None
        return _seq.row_ring(b, s)

    @_served
    @torch.inference_mode()
    def prefill_chunk(self, params, batch, cache, pos0):
        """Append a chunk at positions [pos0, pos0+C): it attends over the
        whole cache, which already holds every earlier chunk.  ``pos0`` is
        an int or a one-element int tensor on the model's device, as the
        reference traces it: one CUDA graph then serves every chunk of a
        shape, wherever it starts.  On a serving mesh, as ``prefill``."""
        if self.cfg.num_prefix_tokens:
            raise ValueError("chunked prefill: no prefix tokens")
        if _seq.current_ring() is not None:
            raise NotImplementedError(f"chunked prefill under a ring "
                                      f"{_seq.NEEDS_NEXT}")
        tokens = batch["tokens"]
        rows = tokens.shape[0]
        with _serving.call(self, rows, params, cache) as part:
            tokens = part.cut(tokens)
            b, s = tokens.shape
            x = self._embed(params, tokens)
            pos0 = (pos0.reshape(()) if isinstance(pos0, torch.Tensor)
                    else int(pos0))
            positions = (pos0 + torch.arange(s, device=x.device))[None]
            h, cache, _ = self._stack(params, x, positions.expand(b, s),
                                      cache, None, "prefill_chunk")
            return part.gather(self._logits(params, h[:, -1:])[:, 0]), cache

    @_served
    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, pos):
        """One token per row: ``tokens`` (B, 1); ``pos`` a scalar or (B,).
        On a serving mesh, as ``prefill``."""
        rows = tokens.shape[0]
        with _serving.call(self, rows, params, cache) as part:
            x = self._embed(params, part.cut(tokens))
            positions = _decode_positions(part.cut(pos), x.shape[0],
                                          x.device)
            h, cache, _ = self._stack(params, x, positions, cache, None,
                                      "decode")
            return part.gather(self._ring_logits(params, h)), cache


# =============================================================================
# encoder-decoder family (whisper)
# =============================================================================

def _enc_layer_defs(cfg: ModelConfig):
    return {"ln1": ln_defs(cfg.d_model), "attn": attn.gqa_defs(cfg),
            "ln2": ln_defs(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff, gated=False)}


def _dec_layer_defs(cfg: ModelConfig):
    return {"ln1": ln_defs(cfg.d_model), "self_attn": attn.gqa_defs(cfg),
            "ln_x": ln_defs(cfg.d_model), "cross_attn": attn.gqa_defs(cfg),
            "ln2": ln_defs(cfg.d_model),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff, gated=False)}


def _ln(x, p, eps):
    return layer_norm(x, p["gamma"], p["beta"], eps)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters (or cache leaves) of a stacked tree."""
    return tree_map(lambda t: t[i], stacked)


@dataclasses.dataclass
class EncDecModel(_TiedLogits):
    """whisper: the encoder (non-causal, no RoPE) runs over frame
    embeddings (the stub conv frontend's output, (B, F, d_model)) with
    learned positions; the decoder is causal self-attention with learned
    positions (no RoPE), cross attention over the encoder's output, and
    an un-gated gelu MLP, all with LayerNorm.  The cache holds the
    self-attention KV per layer and each layer's cross K/V (B, F, KH, D)
    in bf16, computed once where the frames enter (``prefill``, or the
    first ``prefill_chunk``) and read by every later chunk and step."""
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family != "encdec" or self.cfg.attention_type != "gqa":
            raise NotImplementedError(f"{self.cfg.name}: EncDecModel is the "
                                      "GQA encoder-decoder")
        attn.kv_quantized(self.cfg)       # validates kv_quant

    def schema(self):
        cfg = self.cfg
        return {
            "embed": embed_def(cfg.vocab_size, cfg.d_model),
            # decoder learned positions sized for the largest decode shape
            "pos_embed": ParamDef((32_768, cfg.d_model),
                                  (None, "d_model"), torch.bfloat16, "embed"),
            "enc_pos_embed": ParamDef((cfg.encoder_frames, cfg.d_model),
                                      ("frames", "d_model"), torch.bfloat16,
                                      "embed"),
            "enc_layers": stack(_enc_layer_defs(cfg), cfg.encoder_layers),
            "enc_norm": ln_defs(cfg.d_model),
            "dec_layers": stack(_dec_layer_defs(cfg), cfg.num_layers),
            "dec_norm": ln_defs(cfg.d_model),
        }

    def cache_spec(self, batch: int, length: int):
        cfg = self.cfg
        cross = ((cfg.num_layers, batch, cfg.encoder_frames,
                  cfg.num_kv_heads, cfg.head_dim), torch.bfloat16)
        return {"self": _stacked(attn.kv_cache_spec(cfg, batch, length),
                                 cfg.num_layers),
                "cross": {"k": cross, "v": cross}}

    def cache_axes(self):
        cross = ("stack", "batch", "frames", "kv_heads", None)
        return {"self": attn.kv_cache_axes(self.cfg),
                "cross": {"k": cross, "v": cross}}

    @_served
    def init_cache(self, batch: int, length: int, device):
        return _init_cache(self.cache_spec(batch, length), device)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """(B, F, d_model) frame embeddings -> the encoder's output, bf16."""
        cfg = self.cfg
        x = frames.to(torch.bfloat16) + params["enc_pos_embed"][None]
        positions = attn._frame_positions(x.shape[0], x.shape[1], x.device)
        for lp in _unstacked(params["enc_layers"], cfg.encoder_layers):
            h = _ln(x, lp["ln1"], cfg.norm_eps)
            a, _ = attn.gqa_apply(lp["attn"], cfg, h, positions, window=None,
                                  causal=False, rope=False)
            x = x + a
            h = _ln(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, "gelu", False, cfg.matmul_mode)
        return _ln(x, params["enc_norm"], cfg.norm_eps)

    def _decode_stack(self, params, x, positions, enc_out, cache, mode):
        """The decoder layers.  With ``enc_out`` each layer projects its
        cross K/V from it (and stores them in ``cache`` if there is one);
        without, it reads them from ``cache``.  ``mode == "train"`` (no
        cache) recomputes each layer, the cross K/V projections included,
        in the backward when ``cfg.remat``."""
        cfg = self.cfg
        b, kh, hd = x.shape[0], cfg.num_kv_heads, cfg.head_dim

        def layer(x, lp, enc_out, i):
            lc = None if cache is None else _layer(cache["self"], i)
            h = _ln(x, lp["ln1"], cfg.norm_eps)
            a, _ = attn.gqa_apply(lp["self_attn"], cfg, h, positions,
                                  window=None, cache=lc, rope=False,
                                  append=mode == "prefill_chunk")
            x = x + a
            h = _ln(x, lp["ln_x"], cfg.norm_eps)
            if enc_out is None:
                ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
            else:
                f = enc_out.shape[1]
                ck = dense(enc_out, lp["cross_attn"]["wk"],
                           cfg.matmul_mode).reshape(b, f, kh, hd)
                cv = dense(enc_out, lp["cross_attn"]["wv"],
                           cfg.matmul_mode).reshape(b, f, kh, hd)
                if cache is not None:
                    cache["cross"]["k"][i].copy_(ck)
                    cache["cross"]["v"][i].copy_(cv)
            a, _ = attn.gqa_apply(lp["cross_attn"], cfg, h, positions,
                                  window=None, cross_kv=(ck, cv), rope=False)
            x = x + a
            h = _ln(x, lp["ln2"], cfg.norm_eps)
            return x + mlp_apply(lp["mlp"], h, "gelu", False,
                                 cfg.matmul_mode)

        for i, lp in enumerate(_unstacked(params["dec_layers"],
                                          cfg.num_layers)):
            x = (_run_layer(cfg, layer, x, lp, enc_out, i)
                 if mode == "train" else layer(x, lp, enc_out, i))
        return _ln(x, params["dec_norm"], cfg.norm_eps)

    def loss(self, params, batch):
        """Mean next-token cross-entropy of the decoder over ``batch``
        ("frames" (B, F, d_model), "tokens" and "labels" (B, S), optional
        "loss_mask"); returns (loss, metrics).  The encoder runs once (not
        recomputed, as the reference's encoder scan has no checkpoint);
        each decoder layer projects its cross K/V from its output."""
        if "frames" not in batch:
            raise KeyError(
                f"frames: {self.cfg.name}'s loss needs the batch's frame "
                f"embeddings (B, {self.cfg.encoder_frames}, "
                f"{self.cfg.d_model}), as the reference's does; the data "
                f"pipeline's batches (batch_at) carry none: "
                f"launch.inputs.demo_batch makes a batch with them")
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens) + \
            params["pos_embed"][None, :s]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        h = self._decode_stack(params, x, positions, enc_out, None, "train")
        return _xent_loss(h, params["embed"], batch)

    @_served
    @torch.inference_mode()
    def prefill(self, params, batch, cache_len: int):
        """``batch``: "frames" (B, F, d_model) and "tokens" (B, S); returns
        (last-position logits (B, V), cache)."""
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len, enc_out.device)
        x = embed_lookup(params["embed"], tokens) + \
            params["pos_embed"][None, :s]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        h = self._decode_stack(params, x, positions, enc_out, cache,
                               "prefill")
        return self._logits(params, h[:, -1]), cache

    @_served
    @torch.inference_mode()
    def prefill_chunk(self, params, batch, cache, pos0):
        """Append a chunk at positions [pos0, pos0+C).  The first chunk
        carries ``batch["frames"]`` and runs the encoder, filling every
        layer's cross K/V; later chunks read them from the cache.  The
        learned positions are gathered at the tensor ``pos0``, so one
        graph serves every chunk of a shape."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        frames = batch.get("frames")
        enc_out = None if frames is None else self.encode(params, frames)
        pos0 = (pos0.reshape(()) if isinstance(pos0, torch.Tensor)
                else int(pos0))
        positions = pos0 + torch.arange(s, device=tokens.device)
        x = embed_lookup(params["embed"], tokens) + torch.index_select(
            params["pos_embed"], 0, positions)[None]
        h = self._decode_stack(params, x, positions[None].expand(b, s),
                               enc_out, cache, "prefill_chunk")
        return self._logits(params, h[:, -1]), cache

    @_served
    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, pos):
        """One token per row: ``tokens`` (B, 1); ``pos`` a scalar
        (lock-step) or (B,) (paged, a learned position per row)."""
        b = tokens.shape[0]
        x = embed_lookup(params["embed"], tokens)
        positions = _decode_positions(pos, b, x.device)
        x = x + torch.index_select(params["pos_embed"], 0,
                                   positions.reshape(-1)).reshape(b, 1, -1)
        h = self._decode_stack(params, x, positions, None, cache, "decode")
        return self._logits(params, h[:, 0]), cache


# =============================================================================
# hybrid family (zamba2): mamba2 backbone + shared attention block
# =============================================================================

@dataclasses.dataclass
class HybridModel(_TiedLogits):
    """zamba2: ``num_layers / attn_every`` groups, each ``attn_every``
    Mamba2 blocks (RMSNorm, ``mamba2_apply``, residual) then the ONE
    shared attention + gated MLP block, to whose attention each group
    adds its own LoRA (``h @ a_q @ b_q``, in bf16).  The cache holds each
    Mamba2 block's conv and SSM states (dense per row) and each group's
    own KV cache for the shared attention."""
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family != "hybrid" or cfg.attention_type != "gqa":
            raise NotImplementedError(f"{cfg.name}: HybridModel is the GQA "
                                      "hybrid")
        if not cfg.attn_every or cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is "
                             f"not a multiple of attn_every "
                             f"{cfg.attn_every}")
        attn.kv_quantized(cfg)            # validates kv_quant

    def _group_dims(self):
        cfg = self.cfg
        return cfg.num_layers // cfg.attn_every, cfg.attn_every

    def schema(self):
        cfg = self.cfg
        n_groups, per = self._group_dims()
        r = cfg.lora_rank
        return {
            "embed": embed_def(cfg.vocab_size, cfg.d_model),
            "final_norm": norm_def(cfg.d_model),
            "mamba": stack(stack({"block": ssm_mod.mamba2_defs(cfg),
                                  "ln": norm_def(cfg.d_model)}, per),
                           n_groups),
            "shared": {"ln1": norm_def(cfg.d_model),
                       "attn": attn.gqa_defs(cfg),
                       "ln2": norm_def(cfg.d_model),
                       "mlp": mlp_defs(cfg.d_model, cfg.d_ff, True)},
            "lora": stack({
                "a_q": ParamDef((cfg.d_model, r), ("d_model", None)),
                "b_q": ParamDef((r, cfg.num_heads * cfg.head_dim),
                                (None, "heads"), torch.bfloat16, "zeros"),
            }, n_groups),
        }

    def cache_spec(self, batch: int, length: int):
        cfg = self.cfg
        n_groups, per = self._group_dims()
        return {"mamba": _stacked(ssm_mod.mamba2_state_spec(cfg, batch),
                                  n_groups, per),
                "attn": _stacked(attn.kv_cache_spec(cfg, batch, length),
                                 n_groups)}

    def cache_axes(self):
        return {"mamba": {"conv": ("stack", "stack2", "batch", None, "ffn"),
                          "ssm": ("stack", "stack2", "batch", "heads", None,
                                  "state")},
                "attn": attn.kv_cache_axes(self.cfg)}

    @_served
    def init_cache(self, batch: int, length: int, device):
        return _init_cache(self.cache_spec(batch, length), device)

    def _forward(self, params, x, positions, cache, mode):
        """The groups in turn.  ``mode == "train"`` (no cache) recomputes
        each Mamba2 layer in the backward when ``cfg.remat``, as the
        reference checkpoints its Mamba2 scan body; the shared block is
        not recomputed."""
        cfg = self.cfg
        n_groups, per = self._group_dims()
        shared = params["shared"]

        def mamba(x, mp, state):
            h = rms_norm(x, mp["ln"], cfg.norm_eps)
            y, new = ssm_mod.mamba2_apply(mp["block"], cfg, h, state=state)
            if state is not None:           # the states, in place
                for k, v in new.items():
                    state[k].copy_(v)
            return x + y

        loras = _unstacked(params["lora"], n_groups)
        for g, gp in enumerate(_unstacked(params["mamba"], n_groups)):
            for j, mp in enumerate(_unstacked(gp, per)):
                if mode == "train":
                    x = _run_layer(cfg, mamba, x, mp, None)
                    continue
                x = mamba(x, mp, None if cache is None else
                          {k: v[g, j] for k, v in cache["mamba"].items()})
            h = rms_norm(x, shared["ln1"], cfg.norm_eps)
            ac = None if cache is None else _layer(cache["attn"], g)
            a, _ = attn.gqa_apply(shared["attn"], cfg, h, positions,
                                  window=None, cache=ac,
                                  append=mode == "prefill_chunk")
            lora = loras[g]
            a = a + dense(dense(h, lora["a_q"], "bf16"), lora["b_q"], "bf16")
            x = x + a
            h = rms_norm(x, shared["ln2"], cfg.norm_eps)
            x = x + mlp_apply(shared["mlp"], h, cfg.act, True,
                              cfg.matmul_mode)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def loss(self, params, batch):
        """Mean next-token cross-entropy over ``batch`` ("tokens" and
        "labels" (B, S), optional "loss_mask"): the Mamba2 layers from
        the zero state, the shared attention full causal over S; returns
        (loss, metrics)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        h = self._forward(params, x, positions, None, "train")
        return _xent_loss(h, params["embed"], batch)

    @_served
    @torch.inference_mode()
    def prefill(self, params, batch, cache_len: int):
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len, tokens.device)
        x = embed_lookup(params["embed"], tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        h = self._forward(params, x, positions, cache, "prefill")
        return self._logits(params, h[:, -1]), cache

    @_served
    @torch.inference_mode()
    def prefill_chunk(self, params, batch, cache, pos0):
        """Append a chunk at [pos0, pos0+C): the attention caches append
        there, the Mamba2 states carry on from the cache (a one-token
        chunk takes the recurrent step)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        pos0 = (pos0.reshape(()) if isinstance(pos0, torch.Tensor)
                else int(pos0))
        positions = (pos0 + torch.arange(s, device=x.device))[None]
        h = self._forward(params, x, positions.expand(b, s), cache,
                          "prefill_chunk")
        return self._logits(params, h[:, -1]), cache

    @_served
    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, pos):
        x = embed_lookup(params["embed"], tokens)
        positions = _decode_positions(pos, x.shape[0], x.device)
        h = self._forward(params, x, positions, cache, "decode")
        return self._logits(params, h[:, 0]), cache


# =============================================================================
# xLSTM family
# =============================================================================

@dataclasses.dataclass
class XLSTMModel(_TiedLogits):
    """xlstm: ``num_layers / slstm_every`` groups, each ``slstm_every - 1``
    mLSTM blocks then one sLSTM block (RMSNorm, block, residual).  No
    attention and no positions: the cache is each block's recurrent
    state, dense per row, and starts as zeros (``init_cache``): a
    prefill's first mLSTM chunk starts from m = 0 and its sLSTM from
    n = 0, as the reference's prefill does."""
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family != "xlstm":
            raise NotImplementedError(f"{cfg.name}: XLSTMModel is the xlstm "
                                      "family")
        if not cfg.slstm_every or cfg.num_layers % cfg.slstm_every:
            raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is "
                             f"not a multiple of slstm_every "
                             f"{cfg.slstm_every}")

    def _group_dims(self):
        cfg = self.cfg
        return cfg.num_layers // cfg.slstm_every, cfg.slstm_every

    def schema(self):
        cfg = self.cfg
        n_groups, per = self._group_dims()
        return {
            "embed": embed_def(cfg.vocab_size, cfg.d_model),
            "final_norm": norm_def(cfg.d_model),
            "mlstm": stack(stack({"ln": norm_def(cfg.d_model),
                                  "block": ssm_mod.mlstm_defs(cfg)},
                                 per - 1), n_groups),
            "slstm": stack({"ln": norm_def(cfg.d_model),
                            "block": ssm_mod.slstm_defs(cfg)}, n_groups),
        }

    def cache_spec(self, batch: int, length: int):
        """The states of every block; ``length`` is unused (no sequence
        axis)."""
        cfg = self.cfg
        n_groups, per = self._group_dims()
        return {"mlstm": _stacked(ssm_mod.mlstm_state_spec(cfg, batch),
                                  n_groups, per - 1),
                "slstm": _stacked(ssm_mod.slstm_state_spec(cfg, batch),
                                  n_groups)}

    def cache_axes(self):
        m = {"C": ("stack", "stack2", "batch", "heads", None, None),
             "n": ("stack", "stack2", "batch", "heads", None),
             "m": ("stack", "stack2", "batch", "heads")}
        s = {"c": ("stack", "batch", "heads", None),
             "n": ("stack", "batch", "heads", None),
             "h": ("stack", "batch", "heads", None),
             "m": ("stack", "batch", "heads")}
        return {"mlstm": m, "slstm": s}

    @_served
    def init_cache(self, batch: int, length: int, device):
        """The zero state (every leaf is f32)."""
        return _init_cache(self.cache_spec(batch, length), device)

    def _forward(self, params, x, cache, train=False):
        """The groups in turn; the states are read from ``cache`` and
        written back into it in place (None: from the reference's fresh
        start, m = -1e30 and n = 1).  ``train`` (no cache) recomputes
        each mLSTM block in the backward when ``cfg.remat``, as the
        reference checkpoints its mLSTM scan body; the sLSTM block is not
        recomputed."""
        cfg = self.cfg
        n_groups, per = self._group_dims()

        def block(apply, bp, x, state):
            h = rms_norm(x, bp["ln"], cfg.norm_eps)
            y, new = apply(bp["block"], cfg, h, state=state)
            if state is not None:
                for k, v in new.items():
                    state[k].copy_(v)
            return x + y

        slstm = _unstacked(params["slstm"], n_groups)
        for g, gp in enumerate(_unstacked(params["mlstm"], n_groups)):
            for j, mp in enumerate(_unstacked(gp, per - 1)):
                if train:
                    x = _run_layer(cfg, block, ssm_mod.mlstm_apply, mp, x,
                                   None)
                    continue
                x = block(ssm_mod.mlstm_apply, mp, x,
                          None if cache is None else
                          {k: v[g, j] for k, v in cache["mlstm"].items()})
            x = block(ssm_mod.slstm_apply, slstm[g], x,
                      None if cache is None else _layer(cache["slstm"], g))
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def loss(self, params, batch):
        """Mean next-token cross-entropy over ``batch`` ("tokens" and
        "labels" (B, S), optional "loss_mask"), every block from the
        reference's fresh start (not the prefill's zero state); returns
        (loss, metrics)."""
        x = embed_lookup(params["embed"], batch["tokens"])
        h = self._forward(params, x, None, train=True)
        return _xent_loss(h, params["embed"], batch)

    @_served
    @torch.inference_mode()
    def prefill(self, params, batch, cache_len: int):
        """From the zero state; returns (last-position logits, cache)."""
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], cache_len, tokens.device)
        x = embed_lookup(params["embed"], tokens)
        h = self._forward(params, x, cache)
        return self._logits(params, h[:, -1]), cache

    @_served
    @torch.inference_mode()
    def prefill_chunk(self, params, batch, cache, pos0):
        """A chunk continues from the states in ``cache`` (a one-token
        chunk takes the recurrent steps).  ``pos0`` (an int or a
        one-element tensor) is ignored: xLSTM has no positions, so one
        graph serves every chunk of a shape."""
        del pos0
        x = embed_lookup(params["embed"], batch["tokens"])
        h = self._forward(params, x, cache)
        return self._logits(params, h[:, -1]), cache

    @_served
    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, pos):
        """One token per row; ``pos`` is ignored (no positions)."""
        del pos
        x = embed_lookup(params["embed"], tokens)
        h = self._forward(params, x, cache)
        return self._logits(params, h[:, 0]), cache


FAMILIES = {"decoder": DecoderModel, "encdec": EncDecModel,
            "hybrid": HybridModel, "xlstm": XLSTMModel}


def build(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  f"ported yet (ported: {sorted(FAMILIES)})")
    return FAMILIES[cfg.family](cfg)
