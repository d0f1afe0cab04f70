"""How far one training step on the card parts from the CPU's, by depth and
matmul mode, for the three families trained in ``chip_smoke.py`` phase 13,
beside two controls that tell where the parting comes from.

    python scripts/torch_train_card_vs_cpu.py     # needs an NVIDIA card

Each case is ``chip_smoke.compare_train_step`` with its gate off: the arch
at full width from one seeded state, one step of 2 x 32 tokens over
``demo_batch`` on the card and on the CPU, the CPU's step replayed op by op
on the card (``replay_ops``, which still fails on a mismatch), the whole
step's differences printed.  Then the CPU against itself twice:
``jitter_ops`` moves each plain-torch block's f32 output by 2^-20 an
element (noise the size of the replay's differences); ``card_layers``
replaces each layer's output (the recurrent blocks, attention, the MLP,
with their projections and glue) by the card's on the same inputs, and
prints how far those layers differ.  A step that parts under the second
as far as on the card parts through the card's forward rounding, layer by
layer, under the CPU's own backward.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (arch, depth overrides, modes); whisper's depths are (encoder, decoder)
CASES = (("whisper_base", {"encoder_layers": 1, "num_layers": 1},
          ("bp8_fused",)),
         ("whisper_base", {"encoder_layers": 2, "num_layers": 2},
          ("bp8_fused",)),
         ("whisper_base", {}, ("bp8_fused", "bf16")),
         ("zamba2_2p7b", {"num_layers": 6}, ("bp8_fused", "bf16")),
         ("xlstm_1p3b", {"num_layers": 2, "slstm_every": 2},
          ("bp8_fused",)),
         ("xlstm_1p3b", {"num_layers": 8}, ("bp8_fused", "bf16")))


def main() -> None:
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.inputs import demo_batch
    from repro_torch.models import build
    from repro_torch.optim.optimizer import OptimizerConfig

    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for arch, kw, modes in CASES:
        for mode in modes:
            cfg = dataclasses.replace(cs.ft_config(arch, **kw),
                                      matmul_mode=mode)
            host = demo_batch(cfg, ShapeConfig("t", "train", 32, 2),
                              device="cpu")
            depth = (f"{cfg.encoder_layers} + {cfg.num_layers}"
                     if cfg.family == "encdec" else str(cfg.num_layers))
            t0 = time.perf_counter()
            for control in (None, cs.jitter_ops(torch),
                            cs.card_layers(torch)):
                cs.compare_train_step(
                    torch, build(cfg),
                    OptimizerConfig(warmup_steps=5, total_steps=8), host,
                    f"{depth} layers", loss_rtol=1e-5, gate=False,
                    control=control)
            print(f"  ({time.perf_counter() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
