"""Fault-tolerant checkpoints: atomic, integrity-checked, compressed.

The on-disk layout is the reference's (``repro.ckpt.checkpoint``), so a
checkpoint written by either package restores in the other, bitwise:

  <dir>/step_000123.tmp/...   -> written fully, fsync'd, then renamed to
  <dir>/step_000123/
      manifest.json           version 2: the tree's structure (the string
                              ``jax.tree.flatten`` gives for it), shapes,
                              logical dtypes, crc32 a leaf, codec + scale
                              of compressed leaves
      00000.npy .. NNNNN.npy  one file a raw leaf
      NNNNN.q.npy + NNNNN.r.z int8 payload + deflated residual of a leaf
                              stored through the int8_ef codec

Trees are nested dicts whose leaves are tensors, numpy arrays or
numbers, flattened in jax's order (sorted keys).  bfloat16 and fp8
leaves, which ``.npy`` cannot hold, are stored as a uint16/uint8 view
with the logical dtype in the manifest.

Properties:
  * atomic: readers only see complete checkpoints (rename barrier, then
    an fsync of the parent directory); a torn ``.tmp`` left by a crash is
    invisible to ``all_steps`` and removed by ``clean_torn``;
  * integrity-checked: crc32 of each leaf's *logical* bytes checked on
    restore (codec leaves also crc their payload and residual files);
  * structure-checked: the saved structure, not just the leaf count, must
    match the restore target (``TreedefMismatch``);
  * compressed: optimizer moments through ``ckpt.codec``, exact;
  * async: ``save(..., blocking=False)`` copies to the host, then writes
    on a thread; the trainer's path is ``ckpt.manager``;
  * retention: keep the newest ``keep`` checkpoints.

``restore`` puts every leaf on one ``device``: the port's counterpart of
the reference's ``shardings``.  Restoring onto another mesh carving
(elastic re-sharding) waits for the port's distributed layer, ``dist/``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt import codec as _codec
from repro_torch.models.params import tree_leaves, tree_map

_STEP_RE = re.compile(r"^step_(\d{9})$")
_TMP_RE = re.compile(r"^step_(\d{9})\.tmp$")

#: dtypes npy can round-trip natively; anything else (bfloat16, fp8) is
#: stored as a raw uint view with the logical dtype kept in the manifest.
_NATIVE = {"float16", "float32", "float64", "int8", "int16", "int32",
           "int64", "uint8", "uint16", "uint32", "uint64", "bool"}

MANIFEST_VERSION = 2


class CheckpointCorruption(IOError):
    """A leaf failed its crc32 integrity check on restore."""


class TreedefMismatch(ValueError):
    """The restore target's tree structure differs from the saved one."""


def treedef_str(tree) -> str:
    """The structure of a tree of nested dicts as ``str(treedef)`` of
    ``jax.tree.flatten`` prints it, e.g. ``PyTreeDef({'a': *, 'b': {}})``."""
    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def unflatten(like, leaves: Sequence[Any]):
    """``like``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# leaves on the host
# ---------------------------------------------------------------------------

def _host(x) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor of its own (a copy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(x))


def _storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """-> (the numpy array written to disk, logical dtype name)."""
    name = _codec.dtype_name(t)
    t = t.contiguous()
    if name in _NATIVE:
        return t.numpy(), name
    if t.element_size() == 2:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.view(torch.uint8).numpy(), name


def _unstorable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _NATIVE:
        return torch.from_numpy(arr)
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(
            _codec.DTYPES[logical])
    return torch.from_numpy(arr).view(_codec.DTYPES[logical])


def _crc(arr: np.ndarray) -> int:
    """crc32 of an array's bytes, read in place (no copy of the leaf)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _logical_crc(t: torch.Tensor) -> int:
    store, _ = _storable(t)
    return _crc(store)


# ---------------------------------------------------------------------------
# Snapshot (device -> host) and write (host -> disk), as separate steps so
# the manager can overlap the write with later train steps.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Snapshot:
    """A host-side copy of a tree, decoupled from device state."""
    host_leaves: List[torch.Tensor]
    treedef_str: str
    nbytes: int


def snapshot(tree) -> Snapshot:
    """Copy ``tree`` to host memory (waits for device transfers only)."""
    host = [_host(x) for _, x in tree_leaves(tree)]
    return Snapshot(host_leaves=host, treedef_str=treedef_str(tree),
                    nbytes=sum(x.numel() * x.element_size() for x in host))


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_npy(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def write_snapshot(directory: str, step: int, snap: Snapshot, *,
                   keep: int = 3,
                   codecs: Optional[Sequence[Optional[str]]] = None,
                   throttle_s: float = 0.0) -> Dict[str, Any]:
    """Write ``snap`` as the checkpoint for ``step``; returns write stats.

    ``codecs``: a codec name a leaf, aligned with ``snap.host_leaves``
    (``None`` = raw npy, ``"int8_ef"`` = the exact compressed codec; a
    leaf the codec cannot take losslessly is written raw).
    ``throttle_s`` stretches the write (a chaos and test knob: it widens
    the window in which a crash tears the ``.tmp`` directory and in which
    the async writer overlaps train steps).
    """
    codecs = (list(codecs) if codecs is not None
              else [None] * len(snap.host_leaves))
    if len(codecs) != len(snap.host_leaves):
        raise ValueError(f"{len(codecs)} codecs for "
                         f"{len(snap.host_leaves)} leaves")
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "version": MANIFEST_VERSION,
                                "treedef": snap.treedef_str, "leaves": []}
    raw_bytes = stored_bytes = 0
    for i, (leaf, codec) in enumerate(zip(snap.host_leaves, codecs)):
        nbytes = leaf.numel() * leaf.element_size()
        raw_bytes += nbytes
        if codec == "int8_ef" and _codec.encodable(leaf):
            enc = _codec.encode_int8_ef(leaf)
            qname, rname = f"{i:05d}.q.npy", f"{i:05d}.r.z"
            _write_npy(os.path.join(tmp, qname), enc.payload)
            with open(os.path.join(tmp, rname), "wb") as f:
                f.write(enc.residual_z)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append({
                "file": qname, "residual": rname, "codec": "int8_ef",
                "scale": enc.scale, "shape": list(leaf.shape),
                "dtype": enc.dtype, "crc32": _logical_crc(leaf),
                "payload_crc32": zlib.crc32(
                    np.ascontiguousarray(enc.payload).tobytes()),
                "residual_crc32": zlib.crc32(enc.residual_z),
                "raw_bytes": enc.raw_bytes,
                "stored_bytes": enc.stored_bytes,
            })
            stored_bytes += enc.stored_bytes
        else:
            if codec not in (None, "int8_ef"):
                raise ValueError(f"unknown codec {codec!r} for leaf {i}")
            fname = f"{i:05d}.npy"
            store, logical = _storable(leaf)
            _write_npy(os.path.join(tmp, fname), store)
            manifest["leaves"].append({
                "file": fname, "shape": list(leaf.shape),
                "dtype": logical, "crc32": _crc(store),
            })
            stored_bytes += nbytes
        if throttle_s:
            time.sleep(throttle_s / max(1, len(snap.host_leaves)))
    manifest["raw_bytes"] = raw_bytes
    manifest["stored_bytes"] = stored_bytes
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)  # make the rename itself durable
    removed = _retain(directory, keep)
    return {"step": step, "raw_bytes": raw_bytes,
            "stored_bytes": stored_bytes, "path": final,
            "retained_removed": removed}


def save(directory: str, step: int, tree, *, keep: int = 3,
         blocking: bool = True,
         codecs: Optional[Sequence[Optional[str]]] = None
         ) -> Optional[threading.Thread]:
    """Write a checkpoint for ``step``; returns the writer thread if async.

    The low-level one-shot API; a trainer uses ``ckpt.manager``'s
    ``CheckpointManager``, which bounds concurrent writers and joins them
    before blocking saves and retention passes.
    """
    snap = snapshot(tree)

    def _write():
        write_snapshot(directory, step, snap, keep=keep, codecs=codecs)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _retain(directory: str, keep: int) -> List[int]:
    steps = sorted(all_steps(directory))
    removed = steps[:-keep] if keep > 0 else []
    for s in removed:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    return removed


def clean_torn(directory: str) -> List[str]:
    """Remove leftover ``step_*.tmp`` directories (a crash mid-write).

    Safe at any time: a ``.tmp`` directory is never visible to
    ``all_steps``/``restore``, so deleting it loses no completed
    checkpoint.  Returns the removed directory names.
    """
    if not os.path.isdir(directory):
        return []
    removed = []
    for name in sorted(os.listdir(directory)):
        if _TMP_RE.match(name):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            removed.append(name)
    return removed


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load_leaf(path: str, meta: Dict[str, Any], index: int) -> torch.Tensor:
    """Load and integrity-check one leaf (raw or codec)."""
    if meta.get("codec") == "int8_ef":
        payload = np.load(os.path.join(path, meta["file"]))
        crc = zlib.crc32(np.ascontiguousarray(payload).tobytes())
        if crc != meta["payload_crc32"]:
            raise CheckpointCorruption(
                f"corrupt payload in leaf {index} ({meta['file']}): "
                f"crc {crc} != {meta['payload_crc32']}")
        with open(os.path.join(path, meta["residual"]), "rb") as f:
            residual_z = f.read()
        crc = zlib.crc32(residual_z)
        if crc != meta["residual_crc32"]:
            raise CheckpointCorruption(
                f"corrupt residual in leaf {index} ({meta['residual']}): "
                f"crc {crc} != {meta['residual_crc32']}")
        t = _codec.decode_int8_ef(payload, residual_z, meta["scale"],
                                  meta["dtype"], tuple(meta["shape"]))
        crc = _logical_crc(t)
        if crc != meta["crc32"]:
            raise CheckpointCorruption(
                f"codec reconstruction mismatch in leaf {index}: "
                f"crc {crc} != {meta['crc32']}")
        return t
    arr = np.load(os.path.join(path, meta["file"]))
    crc = _crc(arr)
    if crc != meta["crc32"]:
        raise CheckpointCorruption(
            f"checkpoint corruption in leaf {index} "
            f"({meta['file']}): crc {crc} != {meta['crc32']}")
    return _unstorable(arr, meta["dtype"])


def restore(directory: str, step: int, like, *, device="cpu",
            strict_treedef: bool = True):
    """Load the checkpoint for ``step`` into the structure of ``like``, as
    tensors on ``device``.

    ``strict_treedef``: check the *saved* tree structure against
    ``like`` (raises ``TreedefMismatch``), not just the leaf count.
    """
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like, treedef = tree_leaves(like), treedef_str(like)
    if strict_treedef and "treedef" in manifest:
        if manifest["treedef"] != treedef:
            raise TreedefMismatch(
                f"checkpoint tree structure differs from restore target:\n"
                f"  saved:  {manifest['treedef']}\n"
                f"  target: {treedef}")
    if len(flat_like) != len(manifest["leaves"]):
        raise TreedefMismatch(
            f"leaf count mismatch: saved {len(manifest['leaves'])}, "
            f"target {len(flat_like)}")
    out = [_load_leaf(path, meta, i).to(device)
           for i, meta in enumerate(manifest["leaves"])]
    return unflatten(like, out)


def read_manifest(directory: str, step: int) -> Dict[str, Any]:
    """The manifest for ``step`` (layout inspection, tests, tooling)."""
    path = os.path.join(directory, f"step_{step:09d}", "manifest.json")
    with open(path) as f:
        return json.load(f)
