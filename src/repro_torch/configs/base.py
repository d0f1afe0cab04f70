"""Model configuration: the fields the ported families read.

Field names, defaults and meanings follow the reference's
``ModelConfig``; the fields of what is not ported yet (pipeline stages)
are left out until their slice.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

ARCH_IDS = ("gemma3_12b", "h2o_danube_1p8b", "qwen2_72b", "paligemma_3b",
            "granite_moe_1b", "deepseek_v2_236b", "minicpm3_4b",
            "whisper_base", "zamba2_2p7b", "xlstm_1p3b")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # decoder | encdec | hybrid | xlstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    attention_type: str = "gqa"  # gqa | mla
    qkv_bias: bool = False
    window_size: Optional[int] = None        # SWA window (None = full attn)
    local_global_pattern: int = 0            # N local layers per 1 global
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None
    # MLA (minicpm3 / deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MLP
    mlp_gated: bool = True
    act: str = "silu"
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid (zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256         # SSD / mLSTM chunk length
    ssm_decay_bf16: bool = False # store intra-chunk decay matrices in bf16
    attn_every: int = 0          # zamba2: one shared attn block per N mamba
    lora_rank: int = 0           # zamba2 shared-block adapters
    slstm_every: int = 0         # xlstm: one sLSTM per N blocks
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # vlm (paligemma): a bidirectional prefix of patch embeddings
    num_prefix_tokens: int = 0
    # execution policy
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    matmul_mode: str = "bf16"    # bf16 | bp8 | bp8_lowrank | bp8_fused | fp8
    # KV-cache storage: "none" keeps bf16 k/v; "bp8" stores int8 BP codes
    # plus one f32 scale per (token, kv-head)
    kv_quant: str = "none"
    attn_chunk: int = 1024       # KV chunk for memory-efficient attention
    # training: recompute each layer's activations in the backward
    # (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
    remat: bool = True
    # ring-buffer KV caches: keep only ``window_size`` slots per layer,
    # addressed pos % window.  Valid only where every layer is windowed
    # (a uniform window); the lock-step engine serves it, the paged
    # engine refuses it.
    ring_cache: bool = False

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (no full attention over the whole
        sequence in every layer): SSM/hybrid families, or SWA-dominant
        transformers."""
        if self.family in ("hybrid", "xlstm"):
            return True
        return self.window_size is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.config()


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig,
                     seq_shards: int = 1) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell is runnable; the reason if not.
    A full-attention arch cannot hold long_500k's cache on a data x model
    x stage layout unless sequence parallelism (``seq_shards`` > 1) cuts
    its KV cache over a ring (``dist.seq``); sub-quadratic archs never
    needed the ring."""
    if (shape.name == "long_500k" and not cfg.sub_quadratic
            and seq_shards <= 1):
        return False, ("pure full-attention arch: long_500k needs "
                       "sequence parallelism (seq_shards > 1) or "
                       "sub-quadratic attention")
    return True, ""
