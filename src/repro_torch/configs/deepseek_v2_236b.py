"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400 — MLA kv_lora=512, 2 shared + 160 routed experts top-6,
first layer dense (d_ff 12288).  [arXiv:2405.04434; hf]

The full model (~472 GB in bf16) does not fit one H100: one MoE layer's
routed experts alone are 7.55 GB.  The reference's ``pipeline_stages``
(4 on the full config, 2 on the smoke one) is left out until the port
has a pipelined step."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="decoder",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        head_dim=128, d_ff=12288, vocab_size=102_400,
        attention_type="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
        moe_d_ff=1536, first_dense_layers=1, rope_theta=10_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke", family="decoder",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=256, vocab_size=512,
        attention_type="mla", q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
        moe_d_ff=64, first_dense_layers=1, tie_embeddings=False,
        attn_chunk=32,
    )
