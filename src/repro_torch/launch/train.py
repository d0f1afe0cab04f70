"""Training launcher CLI over a seeded random model and synthetic data.

  python -m repro_torch.launch.train --steps 100 --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train --full-config --steps 4
  python -m repro_torch.launch.train --device cpu --matmul-mode bp8
  python -m repro_torch.launch.train --arch xlstm_1p3b --device cpu

Flags follow the reference CLI (``repro.launch.train``), the
``--matmul-mode`` choices too, plus ``--device`` (default ``cuda``;
without CUDA the run stops unless ``--device cpu`` is given).
``--model-shards`` above 1 needs the port's distributed layer and
raises.  Every arch trains from the data pipeline but whisper
(``whisper_base``), whose loss needs frame embeddings the pipeline does
not make: it fails at the first step with the loss's ``KeyError``, as
the reference's launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o_danube_1p8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoint retention (newest N kept)")
    ap.add_argument("--no-async-ckpt", action="store_true",
                    help="block the step loop on every checkpoint write")
    ap.add_argument("--no-compress-opt", action="store_true",
                    help="store optimizer moments raw instead of int8_ef")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="model-parallel mesh axis size (needs the port's "
                         "distributed layer: only 1 runs)")
    ap.add_argument("--restart-on", default="injected",
                    choices=["injected", "any"],
                    help="which faults the supervisor auto-restarts on")
    ap.add_argument("--matmul-mode", default="bf16",
                    choices=["bf16", "bp8", "bp8_lowrank", "fp8"])
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not smoke) architecture config")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (FT demo)")
    ap.add_argument("--metrics", default=None,
                    help="JSONL telemetry path (repro_torch.obs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     Supervisor)
    from repro_torch.train.train_step import NEEDS_DIST
    from repro_torch.train.trainer import TrainerConfig, train

    if args.model_shards > 1:
        raise NotImplementedError(f"--model-shards {args.model_shards} "
                                  f"{NEEDS_DIST}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full_config)
    cfg = dataclasses.replace(cfg, matmul_mode=args.matmul_mode)
    model = build(cfg)
    shape = ShapeConfig("train", "train", args.seq_len, args.global_batch)
    opt = OptimizerConfig(learning_rate=args.lr, warmup_steps=5,
                          total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, keep=args.keep,
                         metrics_path=args.metrics,
                         ckpt_async=not args.no_async_ckpt,
                         ckpt_compress_opt=not args.no_compress_opt)
    injector = (FailureInjector(fail_at_steps=(args.fail_at,))
                if args.fail_at else None)
    print(f"{cfg.name} ({cfg.num_layers} layers, {cfg.matmul_mode}) on "
          f"{device}")

    def run():
        _, hist = train(model, cfg, shape, tcfg, opt_cfg=opt,
                        injector=injector, device=device,
                        on_metrics=lambda s, m: (
                            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                                  f"lr {float(m['lr']):.2e} "
                                  f"gnorm {float(m['grad_norm']):.2f}")
                            if s % 10 == 0 or s == args.steps else None))
        return hist[-1]["step"] if hist else 0

    if injector or args.restart_on == "any":
        sup = Supervisor(max_restarts=3)
        if args.restart_on == "any":
            sup.should_restart = lambda e: True
        out = sup.run(run)
        print(f"finished at step {out['final_step']} after "
              f"{out['restarts']} restart(s)")
        return out["final_step"]
    return run()


if __name__ == "__main__":
    main()
