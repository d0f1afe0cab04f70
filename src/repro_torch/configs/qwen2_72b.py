"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA with QKV bias.  [arXiv:2407.10671; hf]

The full model (~145 GB in bf16) does not fit one H100; the smoke config
exercises the ``qkv_bias`` branch in the CPU tests."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="decoder",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=29568, vocab_size=152_064,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="decoder",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=160, vocab_size=512,
        qkv_bias=True, tie_embeddings=False, attn_chunk=32,
    )
