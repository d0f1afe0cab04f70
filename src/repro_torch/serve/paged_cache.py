"""Paged KV cache: per-slot block tables over a shared physical pool.

The sequence axis is cut into fixed ``block_size`` blocks pooled across
slots; each slot holds a block table, the ordered physical block ids
whose concatenation is its logical cache.  Blocks are reserved at
admission and returned when the request retires.

The layout follows the models' ``cache_axes`` names, whatever the
family:

* a leaf with a ``kv_seq`` axis right after its ``batch`` axis (K/V
  codes and scales, MLA latents, per-token positions) is pooled: in the
  pool that pair becomes (physical block, offset in block);
* a leaf without one (whisper's cross K/V, zamba2's conv and SSM
  states, every leaf of xlstm's cache) is **dense per slot**: its batch
  axis is the slot.

For each step the engine *gathers* a dense view — ``(rows, V)`` tokens,
``V`` a power-of-two number of blocks, and each row's dense leaves —
runs the model on it, then *commits* only the newly written cells and
the live rows' dense leaves.  Rows padded past a slot's table gather
block 0, the permanently unallocated **null block**: its positions are
-1, which the attention masks treat as empty, so padding needs no extra
masking.  A padding row of a decode batch gathers slot 0's dense leaves
and its writes are never committed.  A freed slot is scrubbed: its
blocks back to ``pos = -1`` and its dense rows to zeros (-1 for int32),
so reuse needs no reset and a new request never starts from the last
one's recurrent state.

The pool tensors live on the model's device; gather and commit are
``index_select`` / indexed writes there.
"""
from __future__ import annotations

import collections
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.models.params import tree_leaves

NULL_BLOCK = 0


def round_up_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


class BlockAllocator:
    """Free-list over physical blocks ``1..num_blocks-1`` (0 is null)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = collections.deque(range(1, num_blocks))
        self._used: set = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"pool exhausted: want {n} blocks, {len(self._free)} free")
        out = [self._free.popleft() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._used:
                raise RuntimeError(f"double free of block {b}")
            self._used.discard(b)
            self._free.append(b)


def _set_path(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class PagedCache:
    """Physical pool + block tables + gather/commit cache surgery."""

    def __init__(self, model, *, slots: int, num_blocks: int,
                 block_size: int, device):
        if model.cfg.ring_cache:
            raise ValueError("paged cache: no ring cache (the pool pages "
                             "the sequence itself)")
        if block_size & (block_size - 1):
            raise ValueError("block_size must be a power of two")
        if num_blocks < 2:
            raise ValueError("need at least the null block plus one")
        self.slots, self.num_blocks = slots, num_blocks
        self.block_size = block_size
        self.device = torch.device(device)
        self.allocator = BlockAllocator(num_blocks)
        self.tables: List[List[int]] = [[] for _ in range(slots)]
        axes = dict(tree_leaves(model.cache_axes()))
        dense = dict(tree_leaves(model.cache_spec(slots, block_size)))
        self.paths = []
        self.pool: List[torch.Tensor] = []
        self._bi: List[int] = []
        self._is_kv: List[bool] = []
        for path, kv_spec in tree_leaves(
                model.cache_spec(num_blocks, block_size)):
            ax = axes[path]
            bi = ax.index("batch")
            is_kv = "kv_seq" in ax
            if is_kv and ax.index("kv_seq") != bi + 1:
                raise ValueError(f"cache leaf {path}: kv_seq must follow "
                                 f"batch, axes {ax}")
            shape, dtype = kv_spec if is_kv else dense[path]
            self.paths.append(path)
            self._bi.append(bi)
            self._is_kv.append(is_kv)
            self.pool.append(
                torch.full(shape, -1, dtype=dtype, device=self.device)
                if dtype == torch.int32 else
                torch.zeros(shape, dtype=dtype, device=self.device))

    def leaves(self):
        """(path, pool leaf, batch axis, pooled?) of every leaf."""
        return zip(self.paths, self.pool, self._bi, self._is_kv)

    # -- block accounting ----------------------------------------------

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def alloc_slot(self, slot: int, n_blocks: int) -> None:
        if self.tables[slot]:
            raise RuntimeError(f"slot {slot} already allocated")
        self.tables[slot] = self.allocator.alloc(n_blocks)

    def free_slot(self, slot: int) -> None:
        """Return the slot's blocks and scrub the slot: its blocks'
        positions to -1 (every free block reads as empty) and its dense
        rows to zeros, -1 for int32 (every free slot reads as fresh)."""
        blocks = self.tables[slot]
        self.tables[slot] = []
        if blocks:
            barr = torch.as_tensor(blocks, dtype=torch.int64,
                                   device=self.device)
            for _, leaf, bi, is_kv in self.leaves():
                if is_kv and leaf.dtype == torch.int32:
                    leaf.index_fill_(bi, barr, -1)
            self.allocator.free(blocks)
        for _, leaf, bi, is_kv in self.leaves():
            if not is_kv:
                leaf.select(bi, slot).fill_(
                    -1 if leaf.dtype == torch.int32 else 0)

    # -- gather / commit -----------------------------------------------

    def view_len(self, tokens_needed: int) -> int:
        """Dense-view length covering ``tokens_needed``: a power-of-two
        count of blocks."""
        return round_up_pow2(-(-tokens_needed // self.block_size)) \
            * self.block_size

    def empty_view(self, rows: int, view_tokens: int):
        """An uninitialised view of ``rows`` x ``view_tokens``, for
        ``gather(..., out=)``: a pooled leaf's (block, offset) axes become
        (row, token), a dense leaf's slot axis the row."""
        view: dict = {}
        for path, leaf, bi, is_kv in self.leaves():
            tail = leaf.shape[bi + 2:] if is_kv else leaf.shape[bi + 1:]
            mid = (rows, view_tokens) if is_kv else (rows,)
            _set_path(view, path, torch.empty(
                leaf.shape[:bi] + mid + tail, dtype=leaf.dtype,
                device=self.device))
        return view

    def gather(self, slot_ids: Sequence[int], view_tokens: int, out=None):
        """Dense cache view for ``slot_ids`` rows, ``view_tokens`` wide,
        written into every cell of ``out`` (from ``empty_view``) or of a
        new view.  Slot ids may repeat (padding rows reuse slot 0 for the
        dense leaves; their writes are never committed)."""
        nb = view_tokens // self.block_size
        table = np.full((len(slot_ids), nb), NULL_BLOCK, np.int64)
        for r, s in enumerate(slot_ids):
            row = self.tables[s][:nb]
            table[r, :len(row)] = row
        flat = torch.from_numpy(table.reshape(-1)).to(self.device)
        rows = self._index(slot_ids)
        view = self.empty_view(len(slot_ids), view_tokens) if out is None \
            else out
        for (path, dst), (_, leaf, bi, is_kv) in zip(tree_leaves(view),
                                                     self.leaves()):
            if is_kv:
                want = leaf.shape[:bi] + (len(slot_ids), view_tokens) \
                    + leaf.shape[bi + 2:]
            else:
                want = leaf.shape[:bi] + (len(slot_ids),) \
                    + leaf.shape[bi + 1:]
            if dst.shape != want:
                raise ValueError(f"out {path}: {tuple(dst.shape)}, want "
                                 f"{tuple(want)}")
            if is_kv:           # the pool's (block, offset) as (row, token)
                torch.index_select(leaf, bi, flat, out=dst.view(
                    leaf.shape[:bi] + (len(flat), self.block_size)
                    + leaf.shape[bi + 2:]))
            else:
                torch.index_select(leaf, bi, rows, out=dst)
        return view

    def _commit(self, view, rows, blocks, offs, positions, slots) -> None:
        """Pooled leaves: view cells (rows, positions) to pool cells
        (blocks, offs).  Dense leaves: view rows ``rows[:len(slots)]`` to
        pool slots ``slots``."""
        vleaves = dict(tree_leaves(view))
        for path, leaf, bi, is_kv in self.leaves():
            lead = (slice(None),) * bi
            if is_kv:
                vals = vleaves[path][lead + (rows, positions)]
                leaf[lead + (blocks, offs)] = vals.to(leaf.dtype)
            else:
                leaf.index_copy_(bi, slots, vleaves[path].index_select(
                    bi, rows[:len(slots)]))

    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    def commit_prefill(self, view, slot: int, pos0: int, chunk: int) -> None:
        """Write a slot's prefilled cells ``[pos0, pos0+chunk)``, and its
        dense leaves, from a gathered batch-1 view back to the pool."""
        offsets = np.arange(pos0, pos0 + chunk)
        table = self.tables[slot]
        blocks = [table[o // self.block_size] for o in offsets]
        self._commit(view, self._index(np.zeros(chunk)),
                     self._index(blocks),
                     self._index(offsets % self.block_size),
                     self._index(offsets), self._index([slot]))

    def commit_decode(self, view, rows: Sequence[int],
                      slot_ids: Sequence[int],
                      positions: Sequence[int]) -> None:
        """Write each live row's newly decoded cell (``positions[j]`` of
        slot ``slot_ids[j]``, view row ``rows[j]``), and its dense leaves,
        back to the pool.  Padding rows are simply not listed."""
        if not rows:
            return
        pos = np.asarray(positions, np.int64)
        blocks = [self.tables[s][p // self.block_size]
                  for s, p in zip(slot_ids, pos)]
        self._commit(view, self._index(rows), self._index(blocks),
                     self._index(pos % self.block_size), self._index(pos),
                     self._index(slot_ids))
