"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention with q/kv low-rank compression).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="decoder",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=6400, vocab_size=73_448,
        attention_type="mla", q_lora_rank=768, kv_lora_rank=256,
        qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke", family="decoder",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        attention_type="mla", q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        attn_chunk=32,
    )
