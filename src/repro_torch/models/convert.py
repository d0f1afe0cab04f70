"""Reference trees (as numpy) <-> the port's parameters and train state.

The reference's trees and the port's schema have the same nesting, leaf
names and shapes.  bf16 leaves cross as float32 numpy arrays (exact:
every bf16 value is an f32 value) and go back to ``torch.bfloat16``.
Turning the reference's arrays into numpy (and back) is the caller's
step, so this module never touches jax.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build
from repro_torch.models.params import tree_leaves, tree_map


def params_from_numpy(tree, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Convert ``tree`` (nested dicts of numpy arrays, the reference's
    layout) to tensors of the port's schema dtypes on ``device``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for path, d in tree_leaves(build(cfg).schema()):
        node = tree
        for k in path:
            node = node[k]
        arr = np.asarray(node)
        if arr.shape != d.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, schema "
                             f"wants {d.shape}")
        leaf = torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=d.dtype)
        dst = out
        for k in path[:-1]:
            dst = dst.setdefault(k, {})
        dst[path[-1]] = leaf
    return out


def train_state_from_numpy(tree, cfg: ModelConfig, device) -> Dict[str, Any]:
    """The reference's train state ``{"params", "opt": {"m", "v",
    "step"}}`` (numpy) -> the port's, on ``device``: params in the
    schema's dtypes, moments in f32, step an int32 scalar."""
    dev = resolve_device(device)
    params = params_from_numpy(tree["params"], cfg, dev)

    def moments(src):
        return tree_map(lambda p, a: torch.from_numpy(np.array(a)).to(
            device=dev, dtype=torch.float32).reshape(p.shape), params, src)

    opt = tree["opt"]
    return {"params": params,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}


def train_state_to_numpy(state) -> Dict[str, Any]:
    """The port's train state (or any tree of tensors) -> numpy, bf16
    leaves as (exact) float32 arrays."""
    def host(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(host, state)
