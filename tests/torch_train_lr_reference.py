"""The port's trainer and the JAX reference's on the same run, on the CPU:
h2o-danube-1.8b at its full width with the depth cut, in ``bf16``, the
launcher's 8 x 128 tokens a step for 6 steps (warmup 5), both from the
reference's seeded ``init_state`` (copied across by
``train_state_from_numpy``) and the same data, at one or more learning
rates.  Prints each run's losses, so that what a learning
rate does at full width is seen in the reference itself, not only in the
port (``scripts/torch_train_lr.py`` runs the port alone on the card, at
full depth).

    python tests/torch_train_lr_reference.py [--layers 2] [LR ...]

Not collected by pytest (a run at full width takes ~12 GB of host memory
and about a minute a learning rate at 2 layers).  The reference's step is
compiled without excess precision, as the parity tests compile it.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lrs", nargs="*", type=float, default=[3e-4])
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    steps = 6

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jget_config
    from repro.configs.base import ShapeConfig as JShape
    from repro.models import build as jbuild
    from repro.optim.optimizer import OptimizerConfig as JOpt
    from repro.train import train_step as jts
    from repro.train import trainer as jtrainer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainerConfig, train

    cut = dict(num_layers=args.layers, matmul_mode="bf16")
    jcfg = dataclasses.replace(jget_config("h2o_danube_1p8b"), **cut)
    tcfg = dataclasses.replace(get_config("h2o_danube_1p8b"), **cut)
    jm, tm = jbuild(jcfg), build(tcfg)
    jshape = JShape("t", "train", 128, 8)
    print(f"h2o-danube-1.8b, {args.layers} layers at full width, bf16, "
          f"{steps} steps of 8 x 128 tokens, warmup 5")
    for lr in args.lrs:
        kw = dict(learning_rate=lr, warmup_steps=5, total_steps=steps)
        jopt, topt = JOpt(**kw), OptimizerConfig(**kw)
        step = jax.jit(jts.make_train_step(
            jm, jopt, jts.TrainPlan.for_shape(jcfg, jshape, data_shards=1)),
            compiler_options={"xla_allow_excess_precision": False})
        t0 = time.perf_counter()
        _, want = jtrainer.train(
            jm, jcfg, jshape,
            jtrainer.TrainerConfig(total_steps=steps, ckpt_dir=None),
            opt_cfg=jopt, step_fn=step)
        t1 = time.perf_counter()
        init = jax.tree.map(
            lambda a: np.array(a.astype(jnp.float32)
                               if a.dtype == jnp.bfloat16 else a),
            jts.init_state(jm, jax.random.key(0), jopt))
        _, got = train(tm, tcfg, ShapeConfig("t", "train", 128, 8),
                       TrainerConfig(total_steps=steps, ckpt_dir=None),
                       opt_cfg=topt,
                       state=train_state_from_numpy(init, tcfg, "cpu"),
                       device="cpu")
        t2 = time.perf_counter()
        gap = max(abs(g["loss"] - w["loss"]) for g, w in zip(got, want))
        print(f"lr {lr:g}: reference "
              + ", ".join(f"{h['loss']:.4f}" for h in want)
              + f" ({t1 - t0:.0f}s); port "
              + ", ".join(f"{h['loss']:.4f}" for h in got)
              + f" ({t2 - t1:.0f}s); largest gap {gap:.3g}", flush=True)


if __name__ == "__main__":
    main()
