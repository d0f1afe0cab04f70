"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"``.  A machine without CUDA raises
unless the caller asks for the CPU by name: the port never carries on
silently on the CPU, where the kernels' plain versions would stand in.
"""
from __future__ import annotations

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
