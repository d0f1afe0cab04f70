"""Build and bind the CUDA kernels under ``csrc/``.

Each ``.cu`` source compiles in an ``nvcc`` of its own, all started
together, into an object with a plain C interface; one more ``nvcc`` links
the objects into a shared library, loaded with ``ctypes``.  The library is
built at first use (never at import: machines without ``nvcc`` import this
package too) into ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the last build.  The compilers'
output (``-Xptxas -v``: registers, spills, static shared memory of every
kernel) is kept beside the library as ``nvcc.log``.

Each C entry point launches its kernels (with a workspace memset, an
epilogue or a combine kernel where its design has one) on the stream it
is given and returns ``cudaGetLastError()``; ``launch`` raises on a
non-zero code.  ``launch``
also counts each call in ``LAUNCHES`` (one per launch of a kernel, and
nowhere else), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"       # the build's output: ptxas registers, smem

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = collections.Counter()

_P, _I, _LL, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_uint)
_SIGNATURES = {
    "oisma_absmax": (_P, _I, _LL, _F, _P, _P),
    "oisma_fused_matmul": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _U, _U,
                           _P),
    "oisma_fused_matmul_workspace": (_I, _I, _I, _I),
    "oisma_fused_matmul_smem": (_I, _I),
    "oisma_fused_mlp": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _U, _U, _P),
    "oisma_fused_mlp_workspace": (_I, _I, _I, _I),
    "oisma_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _F, _I, _P),
    "oisma_bp_matmul": (_P, _P, _P, _I, _I, _I, _U, _U, _P),
    "oisma_bp_quantize": (_P, _I, _P, _P, _LL, _P),
    "oisma_popcount": (_P, _I, _P, _I, _I, _I, _P),
}
_RESTYPES = {"oisma_fused_matmul_workspace": _LL,
             "oisma_fused_mlp_workspace": _LL}
#: the C entry points' number for a weight's dtype (``Kind`` in bp_mma.cuh)
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def compile_library(sources, lib: pathlib.Path) -> str:
    """Compile each ``.cu`` of ``sources`` in an nvcc of its own, all at
    once, link them into ``lib``; return the compilers' output."""
    objs, procs = [], []
    for src in sources:
        obj = lib.with_name(f"{pathlib.Path(src).stem}.{os.getpid()}.o")
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(obj)
    log, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [_nvcc(), *ARCH, "-shared", "-o", str(lib), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode:
            failed.append(f"link failed ({res.returncode}):\n{' '.join(cmd)}"
                          f"\n{res.stdout}\n{res.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def build() -> pathlib.Path:
    """Compile the library if this tree's sources have no build yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    log = compile_library([p for p in _sources() if p.suffix == ".cu"], tmp)
    (out_dir / LOG_NAME).write_text(log)
    os.replace(tmp, lib)        # atomic: concurrent builders never see half
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``oisma_<name>``, raise on its CUDA error code,
    and count the launch."""
    err = getattr(library(), f"oisma_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on CUDA, False if every one is on the CPU;
    raise on a mix or on another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
