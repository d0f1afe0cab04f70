"""Synthetic-traffic harness: Poisson arrivals, mixed length
distributions, latency/goodput metrics vs offered load.

The port of the reference's ``repro/serve/traffic.py``, over the port's
``PagedServeEngine``.  Time is the engine step (one ``step()`` = one
unit), so every number here is deterministic for a fixed seed and the
same on every device: the same config gives the reference's record.
With one decode token per live slot per step, the engine's decode
capacity is exactly ``slots`` tokens/step, the ceiling the goodput reads
against.

Metrics per (config, offered load) record:

* ``latency`` p50/p99 — finish step minus arrival step, completed
  requests;
* ``ttft`` p50/p99 — first-token step minus arrival step (queueing +
  chunked prefill);
* ``goodput_tokens_per_step`` — completed requests' output tokens over
  the drain span;
* ``utilization`` — goodput over the ``slots`` tokens/step ceiling.

The request mix is bimodal (mostly short prompts, a heavy tail of long
ones) with uniform output lengths and a priority drawn from a weighted
set: chunked prefill on the tail, admission control under memory
pressure, priority ordering under queueing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serve.paged_engine import PagedRequest, PagedServeEngine


@dataclasses.dataclass
class TrafficConfig:
    num_requests: int = 32
    offered_load: float = 0.25          # expected arrivals per engine step
    short_prompt: tuple = (2, 12)       # uniform-int range, inclusive
    long_prompt: tuple = (24, 56)
    long_frac: float = 0.25             # fraction of prompts from the tail
    max_new: tuple = (4, 24)            # uniform-int range, inclusive
    priorities: tuple = (0, 0, 0, 1)    # drawn uniformly -> 3:1 weighting
    vocab: int = 256                    # prompt token id range (excl. eos 1)
    seed: int = 0


def poisson_arrivals(n: int, rate: float, rng: np.random.Generator):
    """Arrival steps for ``n`` requests at ``rate`` arrivals/step."""
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def make_requests(tcfg: TrafficConfig) -> List[PagedRequest]:
    """The synthetic request mix, arrival steps stamped."""
    rng = np.random.default_rng(tcfg.seed)
    arrivals = poisson_arrivals(tcfg.num_requests, tcfg.offered_load, rng)
    out = []
    for rid, arr in enumerate(arrivals):
        lo, hi = (tcfg.long_prompt if rng.random() < tcfg.long_frac
                  else tcfg.short_prompt)
        plen = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(2, tcfg.vocab, size=plen).astype(np.int32)
        out.append(PagedRequest(
            rid=rid, prompt=prompt,
            max_new_tokens=int(rng.integers(tcfg.max_new[0],
                                            tcfg.max_new[1] + 1)),
            priority=int(tcfg.priorities[rng.integers(len(tcfg.priorities))]),
            arrival_step=int(arr)))
    return out


def summarize_lifecycle(records, *, slots: int, steps: int,
                        requests: int) -> Dict:
    """Reduce per-request lifecycle records to the sweep-record metrics.

    ``run_traffic`` calls it on the engine's lifecycle list; the same
    records give the same numbers in any order.
    """
    latency = np.asarray([r["latency_steps"] for r in records])
    ttft = np.asarray([r["ttft_steps"] for r in records])
    out_tokens = sum(r["output_tokens"] for r in records)
    denom = max(steps, 1)
    pct = lambda a, q: float(np.percentile(a, q)) if len(a) else float("nan")
    return {
        "requests": requests,
        "completed": len(records),
        "steps": int(steps),
        "output_tokens": int(out_tokens),
        "latency_p50": pct(latency, 50),
        "latency_p99": pct(latency, 99),
        "ttft_p50": pct(ttft, 50),
        "ttft_p99": pct(ttft, 99),
        "goodput_tokens_per_step": out_tokens / denom,
        "utilization": out_tokens / denom / slots,
    }


@torch.inference_mode()
def run_traffic(engine: PagedServeEngine, tcfg: TrafficConfig) -> Dict:
    """Inject the mix at its arrival steps, drain, report metrics."""
    requests = make_requests(tcfg)
    pending = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
    qi = 0
    while qi < len(pending) or engine.scheduler.pending or engine.live:
        while (qi < len(pending)
               and pending[qi].arrival_step <= engine.step_count):
            engine.submit(pending[qi])
            qi += 1
        if engine.step_count > tcfg.num_requests * engine.ecfg.max_steps:
            raise RuntimeError("traffic run failed to drain")
        engine.step()
    engine._retire()

    rec = {"offered_load": tcfg.offered_load,
           **summarize_lifecycle(engine.lifecycle, slots=engine.ecfg.slots,
                                 steps=engine.step_count,
                                 requests=len(requests)),
           "prefill_shapes": len(engine.stats.prefill_shapes),
           "decode_shapes": len(engine.stats.decode_shapes)}
    return rec
