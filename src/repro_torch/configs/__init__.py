"""Model configurations ported so far (decoder slice)."""
from repro_torch.configs.base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
