"""Paged serving engine: chunked prefill interleaved with decode over a
block-pool KV cache, fed by a priority scheduler.

Engine loop (one ``step()``):

1. **retire** — finished slots return their blocks to the pool;
2. **admit** — the scheduler offers queued requests that fit the free
   slots/blocks (strict priority, FIFO within a class); each admitted
   request reserves its worst-case block count so it can always finish;
3. **prefill tick** — every prefilling slot advances by one chunk: the
   largest power of two <= min(tokens left, ``max_prefill_tokens``).  A
   long prompt takes several steps and interleaves with other slots'
   decode, and the power-of-two decomposition (13 -> 8+4+1) pads
   nothing, so chunked prefill equals one-shot prefill;
4. **decode tick** — all decoding slots advance one token in one batched
   ``decode_step`` with per-row positions, padded to a constant batch of
   ``slots`` rows (padding rows gather the null block and their writes
   are never committed).

The two model calls run as CUDA graphs on the card (``graphs.py``, the
counterpart of the reference's ``jax.jit``): one per entry point and
shape key, decode keyed by the view length, prefill by (chunk, view
length), each over static buffers that the gather fills; graphs are
captured on first use and their count stays within
``compile_shape_bounds()``.  ``capture=False`` runs the same buffers
eagerly (the counterpart of ``jax.disable_jit()``); on the CPU nothing is
captured.

Sampling is counter-based (``sampling.py``): greedy at temperature 0,
else keyed on ``(seed, rid, step)`` as the reference's, bit for bit.

Time is counted in engine steps (one ``step()`` = one unit); each request
keeps its lifecycle record (arrival, admission, first token, finish).
The host phases of a step run under ``torch.profiler.record_function``
ranges named ``paged.*`` (schedule, gather, the two entry points, commit,
sample), so a profile shows where the host spends a step.

Observability: pass a ``repro_torch.obs.Observability`` to get the
reference's hooks under the reference's names: spans per engine step,
prefill chunk (lane ``1 + slot``) and decode tick on the tracer, the
``submit`` / ``admit`` / ``retire`` instants and the ``blocks_in_use``
trace counter; the ``serve.*`` counters, gauges and histograms on the
registry; and the watchdog around both entry points, bounded by
``compile_shape_bounds()``.  Spans time host work: around a replay they
measure its launch, as the reference's measure a jitted call's dispatch.
Without ``obs`` the engine keeps only its ``EngineStats``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.serve.graphs import GraphedEntry
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.sampling import sample_row, sample_tokens
from repro_torch.serve.scheduler import PriorityScheduler


@dataclasses.dataclass
class PagedRequest:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 16
    priority: int = 0                   # lower = more urgent
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # engine-step timestamps (filled in by the engine)
    arrival_step: int = 0
    admitted_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None


@dataclasses.dataclass
class PagedEngineConfig:
    slots: int = 4                      # concurrent sequences
    block_size: int = 8                 # tokens per cache block (2^k)
    num_blocks: int = 64                # physical pool incl. null block
    max_prefill_tokens: int = 16        # per-slot chunk budget per step (2^k)
    eos_id: int = 1
    temperature: float = 0.0            # 0 = greedy
    seed: int = 0                       # sampling seed (counter-based)
    max_steps: int = 100_000            # drain-loop safety valve


@dataclasses.dataclass
class EngineStats:
    """Shape and tick accounting; ``snapshot()`` is JSON-serializable."""
    prefill_shapes: Set[Tuple] = dataclasses.field(default_factory=set)
    decode_shapes: Set[Tuple] = dataclasses.field(default_factory=set)
    steps: int = 0
    prefill_chunks: int = 0
    decode_ticks: int = 0
    admitted: int = 0
    rejected: int = 0
    deferred_steps: int = 0             # a free slot, but the head-of-line
                                        # request did not fit the blocks
    capture_s: float = 0.0              # graph warm-ups and captures

    def snapshot(self) -> Dict[str, Any]:
        return {
            "steps": self.steps,
            "prefill_chunks": self.prefill_chunks,
            "decode_ticks": self.decode_ticks,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "deferred_steps": self.deferred_steps,
            "prefill_shapes": sorted([list(s) for s in self.prefill_shapes]),
            "decode_shapes": sorted([list(s) for s in self.decode_shapes]),
            "prefill_shape_count": len(self.prefill_shapes),
            "decode_shape_count": len(self.decode_shapes),
            "capture_s": self.capture_s,
        }


def lifecycle_record(req: PagedRequest) -> Dict[str, Any]:
    """One finished request's lifecycle as a flat JSON-safe record."""
    return {
        "kind": "request",
        "rid": req.rid,
        "priority": req.priority,
        "prompt_tokens": int(len(req.prompt)),
        "max_new_tokens": req.max_new_tokens,
        "output_tokens": len(req.out_tokens),
        "arrival_step": req.arrival_step,
        "admitted_step": req.admitted_step,
        "first_token_step": req.first_token_step,
        "finish_step": req.finish_step,
        "queue_wait_steps": req.admitted_step - req.arrival_step,
        "ttft_steps": req.first_token_step - req.arrival_step,
        "latency_steps": req.finish_step - req.arrival_step,
    }


@dataclasses.dataclass
class _Slot:
    req: PagedRequest
    pos: int = 0                        # tokens written to the cache so far
    next_token: Optional[int] = None    # sampled, not yet written

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.req.prompt)


class PagedServeEngine:
    """model: a ``DecoderModel``; ``params`` must live on ``device`` and,
    once a graph is captured, must not be replaced.  ``capture``: run the
    entry points as CUDA graphs (``None``: on CUDA).  ``obs``: an optional
    ``repro_torch.obs.Observability``."""

    @torch.inference_mode()
    def __init__(self, model, params, cfg: ModelConfig,
                 ecfg: PagedEngineConfig, device="cuda",
                 capture: Optional[bool] = None, obs=None):
        if ecfg.max_prefill_tokens & (ecfg.max_prefill_tokens - 1):
            raise ValueError("max_prefill_tokens must be a power of two")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.model, self.params, self.cfg, self.ecfg = model, params, cfg, ecfg
        self.cache = PagedCache(model, slots=ecfg.slots,
                                num_blocks=ecfg.num_blocks,
                                block_size=ecfg.block_size,
                                device=self.device)
        on_cuda = self.device.type == "cuda"
        capture = on_cuda if capture is None else bool(capture)
        if capture and not on_cuda:
            raise ValueError("capture=True needs the engine on CUDA")
        # one memory pool for both entry points: their graphs replay one
        # after another on the engine's stream
        pool = torch.cuda.graph_pool_handle() if capture else None
        self._decode = GraphedEntry(
            lambda tokens, view, pos: model.decode_step(
                self.params, tokens, view, pos),
            capture=capture, pool=pool)
        self._prefill = GraphedEntry(
            lambda tokens, view, pos0: model.prefill_chunk(
                self.params, {"tokens": tokens}, view, pos0),
            capture=capture, pool=pool)
        # what a tick calls: the entries, or the watchdog's wrappers of them
        self._run_decode, self._run_prefill = self._decode, self._prefill
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else None
        self._registry = obs.registry if obs is not None else None
        if obs is not None and obs.watchdog is not None:
            limits = self.compile_shape_bounds()
            self._run_prefill = obs.watchdog.watch(
                self._prefill, "prefill_chunk",
                limit=limits["prefill_chunk"])
            self._run_decode = obs.watchdog.watch(
                self._decode, "decode_step", limit=limits["decode_step"])
        self.scheduler = PriorityScheduler(ecfg.num_blocks - 1,
                                           ecfg.block_size)
        self._slots: List[Optional[_Slot]] = [None] * ecfg.slots
        self.step_count = 0
        self.results: Dict[int, List[int]] = {}
        self.lifecycle: List[Dict[str, Any]] = []
        self.stats = EngineStats()

    @property
    def live(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def capture(self) -> bool:
        return self._decode.capture

    def compile_counts(self) -> Dict[str, int]:
        """Shapes specialised per entry point: graphs captured (or, when
        not capturing, sets of static buffers)."""
        return {"prefill_chunk": self._prefill.count,
                "decode_step": self._decode.count}

    def compile_shape_bounds(self) -> Dict[str, int]:
        """The reference's ceiling on compiled shapes per entry point: chunk
        sizes are the powers of two up to ``max_prefill_tokens``, view
        lengths power-of-two block counts up to the pool, the decode batch
        constant."""
        chunk_kinds = self.ecfg.max_prefill_tokens.bit_length()
        usable = self.ecfg.num_blocks - 1          # pool minus null block
        view_kinds = (1 << max(usable - 1, 1).bit_length()).bit_length()
        encdec = 2 if self.cfg.family == "encdec" else 1
        return {"prefill_chunk": chunk_kinds * view_kinds * encdec,
                "decode_step": view_kinds}

    # -- request intake -------------------------------------------------

    def submit(self, req: PagedRequest) -> None:
        req.arrival_step = self.step_count
        if not self.scheduler.submit(req):
            self.stats.rejected += 1
            if self._registry is not None:
                self._registry.counter("serve.rejected_requests")
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new_tokens} exceeds the cache pool "
                f"({self.ecfg.num_blocks - 1} blocks of "
                f"{self.ecfg.block_size})")
        if self._registry is not None:
            self._registry.counter("serve.submitted_requests")
        if self._tracer is not None:
            self._tracer.instant("submit", rid=req.rid,
                                 prompt_tokens=int(len(req.prompt)),
                                 priority=req.priority,
                                 step=self.step_count)

    # -- engine loop ----------------------------------------------------

    @torch.inference_mode()
    def step(self) -> None:
        """Retire, admit, prefill one chunk per prefilling slot, decode one
        token for every decoding slot."""
        if self._tracer is not None:
            with self._tracer.span("engine_step", step=self.step_count):
                self._ticks()
        else:
            self._ticks()
        self.step_count += 1
        self.stats.steps += 1
        self.stats.capture_s = self._prefill.capture_s + \
            self._decode.capture_s
        if self._registry is not None:
            used = self.ecfg.num_blocks - 1 - self.cache.free_blocks
            self._registry.gauge("serve.blocks_in_use", used)
            self._registry.observe("serve.blocks_in_use_per_step", used)
            self._registry.gauge("serve.queue_depth", self.scheduler.pending)
            self._registry.gauge("serve.live_slots", self.live)
        if self._tracer is not None:
            used = self.ecfg.num_blocks - 1 - self.cache.free_blocks
            self._tracer.counter("blocks_in_use", used)

    def _ticks(self) -> None:
        with record_function("paged.schedule"):
            self._retire()
            self._admit()
        self._prefill_tick()
        self._decode_tick()

    def run(self, requests: List[PagedRequest],
            seed: Optional[int] = None) -> Dict[int, List[int]]:
        """Serve ``requests`` to completion (batch mode: all arrive now);
        ``seed`` replaces the sampling seed of the config."""
        if seed is not None:
            self.ecfg.seed = seed
        for r in requests:
            self.submit(r)
        self.drain()
        return {r.rid: r.out_tokens for r in requests}

    @torch.inference_mode()
    def drain(self) -> None:
        start = self.step_count
        while self.scheduler.pending or any(self._slots):
            if self.step_count - start > self.ecfg.max_steps:
                raise RuntimeError("engine failed to drain (livelock?)")
            self.step()
        self._retire()                   # collect the last finishers

    # -- phases ---------------------------------------------------------

    def _retire(self) -> None:
        for i, s in enumerate(self._slots):
            if s is not None and s.req.done:
                self.results[s.req.rid] = s.req.out_tokens
                self.lifecycle.append(lifecycle_record(s.req))
                if self._registry is not None:
                    self._registry.counter("serve.completed_requests")
                    self._registry.counter("serve.output_tokens",
                                           len(s.req.out_tokens))
                    rec = self.lifecycle[-1]
                    for m in ("queue_wait_steps", "ttft_steps",
                              "latency_steps"):
                        self._registry.observe(f"serve.{m}", rec[m])
                if self._tracer is not None:
                    self._tracer.instant("retire", rid=s.req.rid, slot=i,
                                         output_tokens=len(s.req.out_tokens))
                self.cache.free_slot(i)
                self._slots[i] = None

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        admitted = self.scheduler.admit(len(free), self.cache.free_blocks)
        for req in admitted:
            i = free.pop(0)
            self.cache.alloc_slot(i, self.scheduler.reservation(req))
            req.admitted_step = self.step_count
            self._slots[i] = _Slot(req)
            if self._tracer is not None:
                self._tracer.instant("admit", rid=req.rid, slot=i,
                                     queue_wait=req.admitted_step
                                     - req.arrival_step)
        self.stats.admitted += len(admitted)
        if self._registry is not None and admitted:
            self._registry.counter("serve.admitted_requests", len(admitted))
        if free and self.scheduler.pending:
            self.stats.deferred_steps += 1
            if self._registry is not None:
                self._registry.counter("serve.deferred_steps")

    def _prefill_tick(self) -> None:
        for i, s in enumerate(self._slots):
            if s is None or not s.prefilling:
                continue
            remaining = len(s.req.prompt) - s.pos
            chunk = min(remaining, self.ecfg.max_prefill_tokens)
            chunk = 1 << (chunk.bit_length() - 1)      # largest 2^k <= chunk
            view_tokens = self.cache.view_len(s.pos + chunk)
            key = (chunk, view_tokens)
            tokens, view, pos0 = self._prefill.inputs(key, lambda: (
                torch.empty((1, chunk), dtype=torch.int64,
                            device=self.device),
                self.cache.empty_view(1, view_tokens),
                torch.empty((), dtype=torch.int64, device=self.device)))
            with record_function("paged.gather"):
                tokens.copy_(torch.from_numpy(np.ascontiguousarray(
                    s.req.prompt[s.pos:s.pos + chunk], np.int64))[None])
                pos0.fill_(s.pos)
                self.cache.gather([i], view_tokens, out=view)
            with record_function("paged.prefill_chunk"):
                if self._tracer is None:
                    logits, view = self._run_prefill(key)
                else:
                    with self._tracer.span("prefill_chunk", tid=1 + i,
                                           rid=s.req.rid, chunk=chunk,
                                           view=view_tokens, pos=s.pos):
                        logits, view = self._run_prefill(key)
            with record_function("paged.commit"):
                self.cache.commit_prefill(view, i, s.pos, chunk)
            self.stats.prefill_shapes.add((chunk, view_tokens, False))
            self.stats.prefill_chunks += 1
            if self._registry is not None:
                self._registry.counter("serve.prefill_tokens", chunk)
            s.pos += chunk
            if not s.prefilling:          # prompt complete: first token
                with record_function("paged.sample"):
                    tok = sample_row(logits[0], seed=self.ecfg.seed,
                                     rid=s.req.rid, step=0,
                                     temperature=self.ecfg.temperature)
                self._accept(s, tok)

    def _decode_tick(self) -> None:
        live = [(i, s) for i, s in enumerate(self._slots)
                if s is not None and not s.prefilling and not s.req.done]
        if not live:
            return
        n = self.ecfg.slots
        slot_ids = np.zeros(n, np.int64)      # padding rows gather slot 0
        tokens = np.zeros(n, np.int64)
        positions = np.zeros(n, np.int32)
        rows: List[Optional[Tuple[int, int]]] = [None] * n
        for r, (i, s) in enumerate(live):
            slot_ids[r], tokens[r], positions[r] = i, s.next_token, s.pos
            rows[r] = (s.req.rid, len(s.req.out_tokens))
        view_tokens = self.cache.view_len(int(positions.max()) + 1)
        tok_in, view, pos_in = self._decode.inputs(view_tokens, lambda: (
            torch.empty((n, 1), dtype=torch.int64, device=self.device),
            self.cache.empty_view(n, view_tokens),
            torch.empty((n,), dtype=torch.int32, device=self.device)))
        with record_function("paged.gather"):
            tok_in.copy_(torch.from_numpy(tokens)[:, None])
            pos_in.copy_(torch.from_numpy(positions))
            self.cache.gather(slot_ids.tolist(), view_tokens, out=view)
        with record_function("paged.decode_step"):
            if self._tracer is None:
                logits, view = self._run_decode(view_tokens)
            else:
                with self._tracer.span("decode_tick", rows=len(live),
                                       view=view_tokens):
                    logits, view = self._run_decode(view_tokens)
        with record_function("paged.commit"):
            self.cache.commit_decode(view, list(range(len(live))),
                                     [i for i, _ in live],
                                     [s.pos for _, s in live])
        self.stats.decode_shapes.add((n, view_tokens))
        self.stats.decode_ticks += 1
        if self._registry is not None:
            self._registry.counter("serve.decode_tokens", len(live))
        with record_function("paged.sample"):
            sampled = sample_tokens(logits, rows, seed=self.ecfg.seed,
                                    temperature=self.ecfg.temperature)
        for r, (i, s) in enumerate(live):
            s.pos += 1                     # the input token is now cached
            self._accept(s, int(sampled[r]))

    def _accept(self, s: _Slot, tok: int) -> None:
        req = s.req
        if req.first_token_step is None:
            req.first_token_step = self.step_count
        req.out_tokens.append(tok)
        s.next_token = tok
        if tok == self.ecfg.eos_id or len(req.out_tokens) >= req.max_new_tokens:
            req.done = True
            req.finish_step = self.step_count
