"""Lock-step serving engine: continuous batching over fixed decode slots.

The port of the reference's ``repro/serve/engine.py``, with its
scheduling kept as it is.  A request enters a free slot, is prefilled
into that slot's row of the batched KV cache, and decodes in lock-step
with all other slots; a finished slot is refilled from the queue at once,
with no wave barrier.

Prompts are left-padded (with id 1), so every live slot shares one cache
write position: decode runs with one scalar position for every row over a
contiguous ``max_len`` cache (the model's ``cache_spec``: with
``ring_cache`` a ring of ``min(max_len, window)`` slots written at
pos % slots; xlstm's recurrent states have no length), plus the prefix:
for paligemma each
prompt follows ``num_prefix_tokens`` patch embeddings (zeros from the
stub vision tower), and positions count them; for whisper each prompt's
prefill runs the encoder over ``frames`` (zeros from the stub conv
frontend), whose cross K/V its cache row then holds.  A refilled request is prefilled alone,
left-padded to exactly the current position, and its batch-1 cache row is
scattered into its slot (over ``model.cache_axes()``'s batch axis, so
cross K/V and recurrent states move with it).  A
prompt longer than the current position is deferred, never refilled
mid-stream: it is served once the position has passed its length, or by
the next generation (a fresh cache) once this one drains or exhausts the
cache.

On CUDA ``decode_step`` runs as a CUDA graph (``graphs.GraphedEntry``)
keyed by ``(slots, max_len)``, over a batched cache that the engine owns
and fills in place: each generation's prefill is copied into it and each
refill scattered into it.  ``prefill`` runs eagerly, since its shape
changes with each refill length (the reference's own caveat: it
recompiles there).  ``capture=False`` runs decode eagerly on the same
buffers; on the CPU nothing is captured.

Sampling is the paged engine's (``sampling.py``): counter-based on
``(seed, rid, step)``, so no slot or neighbour changes a request's draws.
Where the model's arithmetic is the same for a row whatever its batch
(``bf16``), a request served alone here gives the paged engine's tokens;
in ``bp8_fused`` each matmul scales its activation by one absmax over
the batch, so the engines' streams part, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_leaves
from repro_torch.serve.graphs import GraphedEntry
from repro_torch.serve.sampling import sample_tokens


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4                  # concurrent sequences
    max_len: int = 256              # cache length per slot
    eos_id: int = 1
    temperature: float = 0.0        # 0 = greedy


class ServeEngine:
    """model: any family's model (``prefill`` + ``decode_step``);
    ``params`` must live on ``device`` and, once a graph is captured, must
    not be replaced.  ``capture``: run ``decode_step`` as CUDA graphs
    (``None``: on CUDA)."""

    def __init__(self, model, params, cfg: ModelConfig, ecfg: EngineConfig,
                 device="cuda", capture: Optional[bool] = None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        on_cuda = self.device.type == "cuda"
        capture = on_cuda if capture is None else bool(capture)
        if capture and not on_cuda:
            raise ValueError("capture=True needs the engine on CUDA")
        self.model, self.params, self.cfg, self.ecfg = model, params, cfg, ecfg
        self._decode = GraphedEntry(
            lambda tokens, cache, pos: model.decode_step(
                self.params, tokens, cache, pos),
            capture=capture,
            pool=torch.cuda.graph_pool_handle() if capture else None)
        self._seed = 0
        # encoder-decoder: every prompt's frame embeddings.  Zeros are the
        # reference's stub; a caller may write its own encoder input in.
        self.frames = (torch.zeros(
            (1, cfg.encoder_frames, cfg.d_model), dtype=torch.bfloat16,
            device=self.device) if cfg.family == "encdec" else None)

    def compile_counts(self) -> Dict[str, int]:
        """Decode shapes specialised: graphs captured (or, when not
        capturing, sets of static buffers)."""
        return {"decode_step": self._decode.count}

    # ------------------------------------------------------------------
    # batch construction / cache surgery
    # ------------------------------------------------------------------

    def _make_batch(self, prompts: List[np.ndarray], plen: int) -> Dict:
        toks = np.ones((len(prompts), plen), np.int64)  # pad with id 1
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p                  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.cfg.num_prefix_tokens:  # the stub vision tower's patches
            batch["patches"] = torch.zeros(
                (len(prompts), self.cfg.num_prefix_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if self.frames is not None:     # the stub conv frontend's frames
            batch["frames"] = self.frames.expand(len(prompts),
                                                 *self.frames.shape[1:])
        return batch

    def _decode_inputs(self, slots: int):
        """The static (tokens, cache, position) of a ``slots``-row decode;
        the cache also holds the prefix."""
        max_len = self.ecfg.max_len
        length = max_len + self.cfg.num_prefix_tokens
        return self._decode.inputs((slots, max_len), lambda: (
            torch.empty((slots, 1), dtype=torch.int64, device=self.device),
            self.model.init_cache(slots, length, self.device),
            torch.empty((), dtype=torch.int32, device=self.device)))

    def _scatter_slot(self, cache, single, slot: int) -> None:
        """Write a batch-1 cache into row ``slot`` of the batched cache, in
        place."""
        axes = tree_leaves(self.model.cache_axes())
        for (_, leaf), (_, one), (_, ax) in zip(tree_leaves(cache),
                                                tree_leaves(single), axes):
            bi = ax.index("batch")
            leaf.select(bi, slot).copy_(one.select(bi, 0))

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def run(self, requests: List[Request],
            seed: int = 0) -> Dict[int, List[int]]:
        """Continuous batching: slots refill from the queue as they
        finish."""
        self._seed = seed
        for r in requests:
            # the cache holds max_len positions and decoding needs >= 1
            if len(r.prompt) > self.ecfg.max_len - 1:
                raise ValueError(
                    f"request {r.rid}: prompt length {len(r.prompt)} "
                    f"exceeds cache capacity (max_len={self.ecfg.max_len})")
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        while queue:
            self._run_generation(queue, results)
        return results

    def _run_generation(self, queue: List[Request],
                        results: Dict[int, List[int]]) -> None:
        ecfg = self.ecfg
        prefix = self.cfg.num_prefix_tokens
        slots_n = min(ecfg.slots, len(queue))
        wave = [queue.pop(0) for _ in range(slots_n)]
        plen = max(len(r.prompt) for r in wave)
        batch = self._make_batch([r.prompt for r in wave], plen)
        logits, fresh = self.model.prefill(self.params, batch, ecfg.max_len)
        tok_in, cache, pos_in = self._decode_inputs(slots_n)
        for (_, leaf), (_, one) in zip(tree_leaves(cache),
                                       tree_leaves(fresh)):
            leaf.copy_(one)
        del fresh
        pos = plen + prefix
        slots: List[Optional[Request]] = list(wave)
        cur = self._sample(logits, slots)
        for i, r in enumerate(slots):
            self._accept(r, int(cur[i]))

        while True:
            # retire finished requests; refill their slots from the queue
            cur = np.array(cur, np.int64)  # writable copy for refills
            for i, r in enumerate(slots):
                if r is not None and r.done:
                    results[r.rid] = r.out_tokens
                    slots[i] = None
            for i in range(slots_n):
                if slots[i] is not None or not queue:
                    continue
                nxt = queue[0]
                pad = pos - prefix
                if len(nxt.prompt) > pad or pad + 1 > ecfg.max_len:
                    # prompt doesn't fit the already-filled region, or no
                    # cache room: defer (a later step or the next
                    # generation's fresh cache takes it, FIFO preserved)
                    break
                queue.pop(0)
                slots[i] = nxt
                slogits, scache = self.model.prefill(
                    self.params, self._make_batch([nxt.prompt], pad),
                    ecfg.max_len)
                self._scatter_slot(cache, scache, i)
                tok = self._sample(slogits, [nxt])
                self._accept(nxt, int(tok[0]))
                cur[i] = tok[0]
            if (all(r is None for r in slots)
                    or pos >= ecfg.max_len + prefix):
                for r in slots:  # out of room: flush whatever is live
                    if r is not None:
                        r.done = True
                        results[r.rid] = r.out_tokens
                return
            tok_in.copy_(torch.from_numpy(cur)[:, None])
            pos_in.fill_(pos)
            logits, _ = self._decode((slots_n, ecfg.max_len))
            pos += 1
            cur = self._sample(logits, slots)
            for i, r in enumerate(slots):
                if r is not None:
                    self._accept(r, int(cur[i]))

    def _accept(self, r: Request, tok: int) -> None:
        r.out_tokens.append(tok)
        if tok == self.ecfg.eos_id or len(r.out_tokens) >= r.max_new_tokens:
            r.done = True

    def _sample(self, logits, slots: List[Optional[Request]]) -> np.ndarray:
        """Counter-based sampling keyed on (seed, rid, step): a request's
        sampled stream is independent of slot layout and neighbours."""
        rows = [None if r is None else (r.rid, len(r.out_tokens))
                for r in slots]
        return sample_tokens(logits, rows, seed=self._seed,
                             temperature=self.ecfg.temperature)
