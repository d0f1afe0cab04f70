"""xlstm-1.3b [ssm]: 48L d_model=2048 4H vocab=50304, d_ff=0 — mLSTM
blocks with an sLSTM block every 8 (xLSTM[7:1]); no separate FFN (the
blocks carry their own up/down projections).  [arXiv:2405.04517;
unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        head_dim=512, d_ff=0, vocab_size=50_304,
        slstm_every=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=0, vocab_size=512,
        slstm_every=2,
    )
