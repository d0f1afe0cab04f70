"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-12b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="decoder",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=15360, vocab_size=262_144,
        window_size=1024, local_global_pattern=5,
        qk_norm=True, rope_theta=1_000_000.0, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="decoder",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        window_size=16, local_global_pattern=5,
        qk_norm=True, act="gelu", attn_chunk=32,
    )
