"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
ssm_state=64 — Mamba2 backbone with a shared attention block (every 6
mamba layers) + per-invocation adapters.  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        head_dim=80, d_ff=10240, vocab_size=32_000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
        attn_every=6, lora_rank=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_conv=4,
        attn_every=2, lora_rank=8, attn_chunk=32,
    )
