"""``DecoderModel``: the decoder family's serving entry points and its
training loss.

Functional like the reference: parameters are a nested dict of tensors
(layer parameters stacked on a leading ``L`` axis) passed to every call,
and a Python loop over the layers takes the place of ``lax.scan``.
Caches are nested dicts of stacked tensors, updated in place layer by
layer.  The model runs wherever its parameters live; the three serving
entry points run under ``torch.inference_mode()``, and ``loss`` under
autograd, each layer recomputed in the backward when ``cfg.remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (chunked_softmax_xent, embed_def,
                                       embed_lookup, linear_def, mlp_apply,
                                       mlp_defs, norm_def, rms_norm)
from repro_torch.models.params import stack, tree_map

BIG_WINDOW = 1 << 30  # "no window"


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
        r = moe_mod.moe_apply(p["moe"], cfg, h)
        m, aux = r["out"], r["aux_loss"]
    else:
        m = mlp_apply(p["mlp"], h, cfg.act, cfg.mlp_gated, cfg.matmul_mode)
    if "post_ln2" in p:
        m = rms_norm(m, p["post_ln2"], cfg.norm_eps)
    return x + m, cache, aux


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
        """{stack: {leaf: ((L, batch, length, ...), dtype)}}."""
        one = attn.kv_cache_spec(self.cfg, batch, length)
        return {name: {k: ((n,) + shape, dtype)
                       for k, (shape, dtype) in one.items()}
                for name, n in self._stacks()}

    def cache_axes(self):
        one = attn.kv_cache_axes(self.cfg)
        return {name: one for name, _ in self._stacks()}

    def init_cache(self, batch: int, length: int, device):
        """Empty cache: zeros, and ``pos = -1`` (empty) everywhere."""
        return tree_map(
            lambda sd: (torch.full(sd[0], -1, dtype=sd[1], device=device)
                        if sd[1] == torch.int32 else
                        torch.zeros(sd[0], dtype=sd[1], device=device)),
            self.cache_spec(batch, length), )

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
            # one view per layer; under autograd, unbind's backward stacks
            # the layers' gradients in one pass
            layers = tree_map(lambda t: t.unbind(0), params[name])
            for i in range(n):
                lp = tree_map(lambda t: t[i], layers)
                window = int(windows[i0 + i])
                if mode == "train":
                    if cfg.remat:
                        x, aux = checkpoint(layer_fn, x, lp, window,
                                            use_reentrant=False)
                    else:
                        x, aux = layer_fn(x, lp, window)
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
        x = embed_lookup(params["embed"], batch["tokens"],
                         scale=self._scaled_embed())
        if self.cfg.num_prefix_tokens and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _prefix(self, b: int, device):
        """(B,) prefix lengths for the mask, or None without a prefix."""
        n = self.cfg.num_prefix_tokens
        return (torch.full((b,), n, dtype=torch.int32, device=device)
                if n else None)

    def _logits(self, params, h):
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        logits = torch.matmul(h.to(torch.float32), w.to(torch.float32))
        if self.cfg.logit_softcap:
            sc = self.cfg.logit_softcap
            logits = torch.tanh(logits / sc) * sc
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
            return loss, {"loss": loss, "aux_loss": aux}
        return loss, {"loss": loss}

    @torch.inference_mode()
    def prefill(self, params, batch, cache_len: int):
        """Prefill ``batch["tokens"]`` (B, S) (after ``batch["patches"]``
        (B, prefix, d_model) for paligemma) into a fresh cache of
        ``cache_len`` plus the prefix; returns (last-position logits
        (B, V), cache)."""
        x = self._embed_in(params, batch)
        b, s, _ = x.shape
        cache = self.init_cache(b, cache_len + self.cfg.num_prefix_tokens,
                                x.device)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        h, cache, _ = self._stack(params, x, positions, cache,
                                  self._prefix(b, x.device), "prefill")
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.inference_mode()
    def prefill_chunk(self, params, batch, cache, pos0):
        """Append a chunk at positions [pos0, pos0+C): it attends over the
        whole cache, which already holds every earlier chunk.  ``pos0`` is
        an int or a one-element int tensor on the model's device, as the
        reference traces it: one CUDA graph then serves every chunk of a
        shape, wherever it starts."""
        if self.cfg.num_prefix_tokens:
            raise ValueError("chunked prefill: no prefix tokens")
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens,
                         scale=self._scaled_embed())
        pos0 = (pos0.reshape(()) if isinstance(pos0, torch.Tensor)
                else int(pos0))
        positions = (pos0 + torch.arange(s, device=x.device))[None]
        h, cache, _ = self._stack(params, x, positions.expand(b, s), cache,
                                  None, "prefill_chunk")
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, params, tokens, cache, pos):
        """One token per row: ``tokens`` (B, 1); ``pos`` a scalar or (B,)."""
        x = embed_lookup(params["embed"], tokens,
                         scale=self._scaled_embed())
        positions = _decode_positions(pos, x.shape[0], x.device)
        h, cache, _ = self._stack(params, x, positions, cache, None,
                                  "decode")
        return self._logits(params, h)[:, 0], cache


def build(cfg: ModelConfig) -> DecoderModel:
    return DecoderModel(cfg)
