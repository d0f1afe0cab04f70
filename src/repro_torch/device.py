"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"``.  A machine without CUDA raises
unless the caller asks for the CPU by name: the port never carries on
silently on the CPU, where the kernels' plain versions would stand in.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and
    this machine has none.  Turns TF32 off: the reference's float32 glue
    is true float32."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch versions of the kernels instead")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_constant(make):
    """Decorate ``make(*key)`` (a device among the hashable key) to run once
    per key and return the same tensor after.

    A CUDA tensor made from a host value is copied from the host, which
    synchronises and which a CUDA graph capture forbids.  So the served
    path makes each such constant on its first, eager call and reuses it
    under capture.  It is made outside inference mode, so that it may also
    take part in autograd."""
    @functools.lru_cache(None)
    @functools.wraps(make)
    def made(*key, **kw):
        with torch.inference_mode(False):
            return make(*key, **kw)
    return made
