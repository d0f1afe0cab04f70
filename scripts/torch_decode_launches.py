"""Device launches and device time that one decode layer of the port adds,
by kernel, on one NVIDIA card.

Run from the root of a checkout on a machine with a card and nvcc:

    python scripts/torch_decode_launches.py [--src PATH] [--label NAME]

``--src`` is the ``src`` directory of the port to measure (by default
this checkout's), so that two trees can be compared in one process
order: unpack the other tree with ``git archive`` into a directory that
``.gitignore`` lists and pass its ``src``.  Each tree builds its own
kernels.  The model is h2o-danube-1.8b at full width in ``bp8_fused`` +
``bp8`` with seeded random weights; a decode step of 4 rows over a
256-token cache is profiled at 2 and 3 layers (``decode_layer_launches``
in ``chip_smoke.py``) and the difference printed as one JSON line with
the card's name and power limit.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available: this script needs a card")
    cfg = dataclasses.replace(get_config("h2o_danube_1p8b"),
                              matmul_mode="bp8_fused", kv_quant="bp8",
                              num_layers=3)
    params = init_params(build_model(cfg).schema(), seed=0, device="cuda")
    res = chip_smoke.decode_layer_launches(torch, cfg, params)
    res.update(label=args.label, src=args.src, card=chip_smoke.card_line())
    print(json.dumps(res))


if __name__ == "__main__":
    main()
