"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — the SigLIP vision tower is a stub (callers pass
precomputed patch embeddings as ``batch["patches"]``); a gemma decoder
with a bidirectional prefix.  [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="decoder",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=257_216,
        num_prefix_tokens=256, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", family="decoder",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        num_prefix_tokens=8, act="gelu", attn_chunk=32,
    )
