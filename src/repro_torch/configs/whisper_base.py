"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder; the conv frontend is a stub: the caller supplies
precomputed frame embeddings.  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51_865,
        encoder_layers=6, encoder_frames=1500, mlp_gated=False, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        encoder_layers=2, encoder_frames=32, mlp_gated=False, act="gelu",
        attn_chunk=32,
    )
