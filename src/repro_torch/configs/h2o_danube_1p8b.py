"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="decoder",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        head_dim=80, d_ff=6912, vocab_size=32_000,
        window_size=4096, rope_theta=10_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="decoder",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=160, vocab_size=512,
        window_size=16, tie_embeddings=False, attn_chunk=32,
    )
