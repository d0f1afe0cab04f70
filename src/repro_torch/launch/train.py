"""Training launcher CLI over a seeded random model and synthetic data.

  python -m repro_torch.launch.train --steps 100 --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train --full-config --steps 4
  python -m repro_torch.launch.train --device cpu --matmul-mode bp8
  python -m repro_torch.launch.train --arch xlstm_1p3b --device cpu

  python -m repro_torch.launch.train --model-shards 2 --steps 10
  python -m repro_torch.launch.train --model-shards 2 --stages 2 --device cpu

Flags follow the reference CLI (``repro.launch.train``), the
``--matmul-mode`` choices too, plus ``--device`` (default ``cuda``;
without CUDA the run stops unless ``--device cpu`` is given) and
``--stages``.  ``--model-shards N`` (and ``--stages S``) trains on a mesh
of S x N ranks, (S, 1, N) over ("stage", "data", "model"), that the
launcher starts itself (``launch.mesh.launch_ranks``: gloo where the
ranks share one card or the CPU, nccl where each has its own card); it
returns rank 0's last step, and any rank's failure fails it.  The
decoder family trains on a mesh; the others refuse it.  Every arch
trains from the data pipeline without a mesh but whisper
(``whisper_base``), whose loss needs frame embeddings the pipeline does
not make: it fails at the first step with the loss's ``KeyError``, as
the reference's launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def _parser() -> argparse.ArgumentParser:
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
                    help="model-parallel mesh axis size (ranks started by "
                         "the launcher; a checkpoint resumes on any other "
                         "carving)")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages (a stage mesh of stages x "
                         "model-shards ranks)")
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
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    ranks = args.model_shards * args.stages
    if ranks > 1:
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import launch_ranks
        resolve_device(args.device)
        return launch_ranks(_rank_main, ranks, argv, device=args.device,
                            timeout=float("inf"))[0]
    return _run(args, args.device, None)


def _rank_main(device, argv):
    """One rank of a mesh run: the mesh over every rank, then ``_run``."""
    from repro_torch.launch.mesh import make_host_mesh
    args = _parser().parse_args(argv)
    mesh = make_host_mesh(model=args.model_shards, stages=args.stages,
                          device=device)
    return _run(args, device, mesh)


def _run(args, device, mesh):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     Supervisor)
    from repro_torch.train.trainer import TrainerConfig, train

    device = resolve_device(device)
    lead = mesh is None or mesh.position == 0
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
    if lead:
        print(f"{cfg.name} ({cfg.num_layers} layers, {cfg.matmul_mode}) on "
              f"{device}" + (f", mesh {mesh.shape} of {mesh.backend} ranks"
                             if mesh is not None else ""))

    def run():
        _, hist = train(model, cfg, shape, tcfg, opt_cfg=opt,
                        injector=injector, device=device, mesh=mesh,
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
        if lead:
            print(f"finished at step {out['final_step']} after "
                  f"{out['restarts']} restart(s)")
        return out["final_step"]
    return run()


if __name__ == "__main__":
    main()
