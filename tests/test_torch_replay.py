"""``chip_smoke.py``'s train-step replay and its control, on the CPU.

``compare_train_step`` replays the CPU's step op by op on a second device
(``replay_ops``: the BP kernels' ops and their straight-through backward,
and the plain-torch blocks forward and backward) and fails if a block or
kernel the family's step must reach (``replay_reach``) was never
replayed: a renamed or inlined op would otherwise go unchecked.  Here the
second device is the CPU too, at the smoke configs, so every replayed op
must agree bitwise and the two steps must agree under every whole-step
rule.  The controls of ``scripts/torch_train_card_vs_cpu.py``:
``jitter_ops`` must move the step, and only by a little at this depth;
``card_layers``, its second device the CPU here, must move nothing and
see every layer function the step calls, also where the step's CPU half
follows it (``follow_card``) under the replay.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys

import pytest

from _torch_tests import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.inputs import demo_batch  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402

ARCHS = ("h2o_danube_1p8b", "whisper_base", "zamba2_2p7b", "xlstm_1p3b")
OPT = OptimizerConfig(warmup_steps=5, total_steps=8)


def _case(arch, mode):
    cfg = dataclasses.replace(get_config(arch, smoke=True), matmul_mode=mode,
                              kv_quant="none")
    return cfg, demo_batch(cfg, ShapeConfig("t", "train", 32, 2),
                           device="cpu")


@pytest.mark.parametrize("mode", ["bp8_fused", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_reaches_every_op_bitwise(arch, mode):
    cfg, host = _case(arch, mode)
    rep = cs.compare_train_step(torch, build(cfg), OPT, host, "smoke", "cpu")
    assert rep["faults"] == []
    reached = {k for k, v in rep["replay"].items() if v["calls"]}
    assert cs.replay_reach(cfg) <= reached
    assert all(v["worst_share"] == 0.0 for v in rep["replay"].values())
    assert rep["loss_card"] == rep["loss_cpu"]


def test_replay_names_what_it_never_saw():
    cfg, _ = _case("xlstm_1p3b", "bp8_fused")
    with cs.replay_ops(torch, "cpu") as rp:
        pass
    assert rp.missed(cfg) == sorted(cs.replay_reach(cfg))
    assert {"_slstm_scan_grad0", "_mlstm_chunked_grad0",
            "_MatmulSTE_grad0"} <= set(rp.missed(cfg))


@pytest.mark.parametrize("arch", ["whisper_base", "xlstm_1p3b"])
def test_jitter_control_moves_the_step_a_little(arch):
    cfg, host = _case(arch, "bf16")
    rep = cs.compare_train_step(torch, build(cfg), OPT, host, "smoke", "cpu",
                                gate=False, control=cs.jitter_ops(torch))
    assert rep["replay"] == {}
    assert rep["loss_card"] != rep["loss_cpu"]
    assert abs(rep["loss_card"] / rep["loss_cpu"] - 1) < 1e-3
    cosines = [v["cosine"] for v in rep["leaves"].values()
               if v.get("cosine") is not None]
    assert min(cosines) > 0.99


@pytest.mark.parametrize("arch,layers", [
    ("whisper_base", {"gqa_apply", "mlp_apply"}),
    ("zamba2_2p7b", {"mamba2_apply", "gqa_apply", "mlp_apply"}),
    ("xlstm_1p3b", {"mlstm_apply", "slstm_apply"})])
def test_card_layers_control_on_the_cpu_is_the_cpu(arch, layers):
    cfg, host = _case(arch, "bp8_fused")
    control = cs.card_layers(torch, "cpu")
    rep = cs.compare_train_step(torch, build(cfg), OPT, host, "smoke", "cpu",
                                control=control)
    assert rep["faults"] == []
    assert rep["loss_card"] == rep["loss_cpu"]
    assert set(control.stats) == layers
    assert all(n and a == b == c == 0.0
               for n, a, b, c in control.stats.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_step_following_the_layers_of_a_second_device(arch):
    cfg, host = _case(arch, "bp8_fused")
    rep = cs.compare_train_step(torch, build(cfg), OPT, host, "smoke", "cpu",
                                follow_card=True)
    assert rep["faults"] == []
    assert set(rep["layers"]) == cs.layer_reach(cfg)
    assert cs.replay_reach(cfg) <= {k for k, v in rep["replay"].items()
                                    if v["calls"]}


def test_chip_smoke_defines_each_module_name_once():
    """A module-level name bound twice in ``chip_smoke.py`` (a later
    phase's constant reusing an earlier one's name) silently rebinds the
    earlier phase's: its kernels line entries land under the later
    phase's path."""
    import ast
    import collections
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    seen = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            seen[node.name] += 1
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        seen[n.id] += 1
    assert [n for n, c in seen.items() if c > 1] == []
