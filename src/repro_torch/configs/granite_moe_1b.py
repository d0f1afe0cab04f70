"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="decoder",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49_155,
        num_experts=32, num_experts_per_tok=8, moe_d_ff=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="decoder",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=512,
        num_experts=8, num_experts_per_tok=2, moe_d_ff=64,
        attn_chunk=32,
    )
