"""The model zoo ported so far: params, layers, attention, MoE, Mamba2,
the decoder, encoder-decoder and hybrid families, and the converter from
the reference's param tree."""
from repro_torch.models.model import (DecoderModel, EncDecModel,
                                      HybridModel, build)

__all__ = ["DecoderModel", "EncDecModel", "HybridModel", "build"]
