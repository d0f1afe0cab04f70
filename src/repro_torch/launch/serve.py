"""Serving launcher CLI: batched prefill+decode over a seeded random model.

  python -m repro_torch.launch.serve --requests 8            # lock-step
  python -m repro_torch.launch.serve --paged --requests 8    # paged
  python -m repro_torch.launch.serve --paged --full-config --temperature 0.8
  python -m repro_torch.launch.serve --device cpu            # plain path
  python -m repro_torch.launch.serve --arch gemma3_12b --paged --full-config
  python -m repro_torch.launch.serve --arch paligemma_3b --full-config
  python -m repro_torch.launch.serve --arch granite_moe_1b --paged --full-config
  python -m repro_torch.launch.serve --arch whisper_base --paged --full-config
  python -m repro_torch.launch.serve --arch zamba2_2p7b --paged --full-config
  python -m repro_torch.launch.serve --arch xlstm_1p3b --paged --full-config

Flags follow the reference CLI, plus ``--device`` (default ``cuda``;
without CUDA the run stops unless ``--device cpu`` is given).  ``--paged``
runs the ``PagedServeEngine`` (paged KV cache, priority scheduler,
chunked prefill); without it the lock-step ``ServeEngine`` serves, as in
the reference.  The archs are ``repro_torch.configs.base.ARCH_IDS``;
paligemma (a prefix of zero patch embeddings) serves on the lock-step
engine only, and ``--paged`` refuses it; whisper's encoder runs over the
engines' stub frames (zeros), as the reference's; zamba2 keeps its Mamba2
states per slot, and xlstm its mLSTM and sLSTM states (its only cache).
The model runs the paper's path,
``matmul_mode="bp8_fused"`` with a ``bp8`` KV cache (the MLA archs,
deepseek-v2 and minicpm3, keep their bf16 latent cache: the reference
refuses a ``bp8`` one).
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o_danube_1p8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="paged engine: block-pool cache, chunked prefill, "
                         "priority scheduler")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-prefill-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.models.params import init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full_config)
    cfg = dataclasses.replace(cfg, matmul_mode="bp8_fused", kv_quant=(
        "none" if cfg.attention_type == "mla" else "bp8"))
    model = build(cfg)
    params = init_params(model.schema(), seed=0, device=device)
    rng = np.random.default_rng(0)

    def prompts():
        return [rng.integers(3, cfg.vocab_size, 4 + i % 4).astype(np.int32)
                for i in range(args.requests)]

    if args.paged:
        from repro_torch.serve.paged_engine import (PagedEngineConfig,
                                                    PagedRequest,
                                                    PagedServeEngine)
        engine = PagedServeEngine(model, params, cfg, PagedEngineConfig(
            slots=args.slots, block_size=args.block_size,
            num_blocks=args.num_blocks,
            max_prefill_tokens=args.max_prefill_tokens,
            temperature=args.temperature), device=device)
        reqs = [PagedRequest(rid=i, prompt=p, max_new_tokens=args.max_new,
                             priority=i % 2)
                for i, p in enumerate(prompts())]
    else:
        from repro_torch.serve.engine import (EngineConfig, Request,
                                              ServeEngine)
        engine = ServeEngine(model, params, cfg,
                             EngineConfig(slots=args.slots, max_len=64,
                                          temperature=args.temperature),
                             device=device)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=args.max_new)
                for i, p in enumerate(prompts())]
    t0 = time.perf_counter()
    results = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"{cfg.name} on {device}: {len(results)} requests, {n_tok} tokens, "
          f"{dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    if args.paged:
        print(f"  engine steps {engine.step_count}, shapes: prefill "
              f"{len(engine.stats.prefill_shapes)}, decode "
              f"{len(engine.stats.decode_shapes)}")
    for rid in sorted(results):
        print(f"  req {rid}: {results[rid]}")
    return results


if __name__ == "__main__":
    main()
