"""Parameter schema: nested dicts of ``ParamDef`` and a seeded init.

The schema mirrors the reference's (same tree, shapes, dtypes and
logical axes; layer parameters stacked on a leading ``L`` axis), so a
reference param tree converts leaf for leaf (``convert.py``).  The init
follows the reference's std rules (normal with std ``scale/sqrt(fan_in)``,
fan_in = second-to-last dim; ``embed`` std 1; zeros; ones) from a
``torch.Generator``.  It cannot replay ``jax.random``, and one seed gives
the same weights only on the same device type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"      # normal | zeros | ones | embed
    scale: float = 1.0        # fan-in override multiplier

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree, *rest):
    """Map over the leaves of nested dicts (sorted keys, as jax orders)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree, prefix: Tuple[str, ...] = ()):
    """[(path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in ``tree_leaves``'
    order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def stack(schema, n: int, axis_name: str = "stack"):
    """Prepend a stacking dimension to every ParamDef in a subtree."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes,
                                       d.dtype, d.init, d.scale), schema)


def axes_tree(schema):
    """The logical axis names of every leaf of a schema."""
    return tree_map(lambda d: d.axes, schema)


def _init_leaf(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = 1.0 if d.init == "embed" else d.scale / math.sqrt(max(1, fan_in))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(d.dtype)     # in place: one f32 copy at a time


def init_params(schema, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Materialise a schema with seeded normal draws on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda d: _init_leaf(d, gen, dev), schema)


def param_count(schema) -> int:
    """Elements in a schema's leaves, read from their shapes: nothing is
    allocated, so it serves the full configs' sizes."""
    return sum(math.prod(d.shape) for _, d in tree_leaves(schema))
