"""Decoder slice of the model zoo: params, layers, GQA attention,
``DecoderModel`` and the converter from the reference's param tree."""
from repro_torch.models.model import DecoderModel, build

__all__ = ["DecoderModel", "build"]
