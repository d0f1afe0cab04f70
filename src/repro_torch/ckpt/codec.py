"""Per-leaf checkpoint codec: int8 error-feedback compression, exact.

The ``int8_ef`` codec stores a float leaf as three parts:

  * **payload** — int8 quantisation codes (1 byte an element; the encode
    math is ``optim.compress.compress_leaf_host``);
  * **scale** — one f32 scalar a leaf, recorded in the manifest;
  * **residual** — the f32 quantisation error, deflate-compressed.

Reconstruction is **bitwise exact**: ``q*scale + residual`` recovers the
f32 view of the leaf exactly (Sterbenz's lemma for ``q != 0``; for
``q == 0`` the residual *is* the value), and the cast back to the logical
dtype (bf16/fp16/fp8) is the identity.  ``encode_int8_ef`` checks this
round trip on every leaf and raises ``CodecError`` rather than write a
lossy checkpoint.  The format is the reference's ``repro.ckpt.codec``,
byte for byte.

Host leaves are CPU tensors.  numpy has no bfloat16 or fp8, so the
module keeps its own registry of logical dtype names (numpy's names, as
the manifest records them) and their torch dtypes.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.optim.compress import compress_leaf_host, decompress_leaf_host

#: logical dtype name (numpy's spelling, as manifests record it) -> torch
DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}

#: dtypes the int8_ef codec accepts: their f32 view is exact, so the f32
#: round trip is the identity on the logical values.
_CODEC_OK = ("float32", "bfloat16", "float16", "float8_e4m3fn",
             "float8_e5m2")


class CodecError(RuntimeError):
    """A codec failed its exact-restore check (never expected; raised
    instead of silently writing a lossy checkpoint)."""


@dataclasses.dataclass(frozen=True)
class EncodedLeaf:
    """One leaf's compressed representation, ready to write."""
    payload: np.ndarray        # int8 codes, original shape
    residual_z: bytes          # deflate(f32 residual bytes)
    scale: float               # per-leaf scale (manifest field)
    dtype: str                 # logical dtype name
    raw_bytes: int
    payload_bytes: int
    stored_bytes: int          # payload + compressed residual


def dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in NAMES:
        raise TypeError(f"no checkpoint dtype for {t.dtype}")
    return NAMES[t.dtype]


def leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor's bytes, as a flat uint8 tensor."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def encodable(t: torch.Tensor) -> bool:
    """True if ``t`` (a CPU tensor) can go through the int8_ef codec
    losslessly."""
    if NAMES.get(t.dtype) not in _CODEC_OK or t.numel() == 0:
        return False
    # inf/nan would poison the scale; such leaves store raw
    return bool(np.isfinite(_f32(t)).all())


def encode_int8_ef(t: torch.Tensor) -> EncodedLeaf:
    """Encode one float leaf (a CPU tensor); checks bitwise-exact
    reconstruction."""
    if not encodable(t):
        raise CodecError(f"leaf not encodable: dtype={t.dtype} "
                         f"size={t.numel()}")
    g32 = _f32(t)
    q, scale, residual = compress_leaf_host(g32)
    recon = _reconstruct(q, scale, residual)
    if recon.tobytes() != g32.tobytes():
        raise CodecError("int8_ef round-trip not exact in f32")
    if not torch.equal(leaf_bytes(torch.from_numpy(recon).to(t.dtype)),
                       leaf_bytes(t)):
        raise CodecError(f"int8_ef cast back to {t.dtype} not exact")
    residual_z = zlib.compress(residual.tobytes(), 6)
    raw = t.numel() * t.element_size()
    return EncodedLeaf(payload=q, residual_z=residual_z, scale=float(scale),
                       dtype=dtype_name(t), raw_bytes=raw,
                       payload_bytes=q.nbytes,
                       stored_bytes=q.nbytes + len(residual_z))


def _reconstruct(q: np.ndarray, scale, residual: np.ndarray) -> np.ndarray:
    """``q*scale + residual``, except where ``q == 0`` the residual IS the
    value: ``(+0.0) + (-0.0)`` would otherwise lose a negative zero."""
    return np.where(q == 0, residual,
                    decompress_leaf_host(q, np.float32(scale)) + residual)


def decode_int8_ef(payload: np.ndarray, residual_z: bytes, scale: float,
                   dtype: str, shape) -> torch.Tensor:
    """Invert ``encode_int8_ef`` -> the original leaf (a CPU tensor),
    bitwise."""
    residual = np.frombuffer(zlib.decompress(residual_z),
                             np.float32).reshape(shape)
    recon = _reconstruct(payload, scale, residual)
    return torch.from_numpy(np.ascontiguousarray(recon.reshape(shape))).to(
        DTYPES[dtype])
