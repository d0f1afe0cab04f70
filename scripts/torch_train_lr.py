"""Train the full h2o-danube-1.8b for a few steps on one card, across matmul
modes and learning rates, and print each run's losses and step times.

    python scripts/torch_train_lr.py            # needs an NVIDIA card

Each run starts from the same seeded weights and reads the same batches
(8 x 128 tokens a step, the training launcher's defaults); only the mode,
the peak learning rate and the warmup differ.  It shows at which learning
rate the first steps of AdamW stay stable at full width.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

#: (matmul mode, peak learning rate, warmup steps)
RUNS = (("bf16", 3e-4, 5), ("bp8_fused", 3e-4, 5), ("bp8_fused", 1e-4, 5),
        ("bp8_fused", 3e-5, 5), ("bf16", 3e-5, 5), ("bp8_fused", 3e-4, 100))


def main(steps: int = 6) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainerConfig, train

    full = get_config("h2o_danube_1p8b")
    for mode, lr, warmup in RUNS:
        cfg = dataclasses.replace(full, matmul_mode=mode)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        hist = train(build(cfg), cfg, ShapeConfig("t", "train", 128, 8),
                     TrainerConfig(total_steps=steps, ckpt_dir=None),
                     opt_cfg=OptimizerConfig(learning_rate=lr,
                                             warmup_steps=warmup,
                                             total_steps=steps),
                     device="cuda")[1]
        print(mode, lr, warmup, "losses",
              [round(h["loss"], 3) for h in hist], "step s",
              [round(h["dt"], 3) for h in hist],
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
              f"{time.time() - t0:.0f}s", flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
