"""The port stands alone: it imports neither jax nor the reference
package, and its entry points never carry on silently on the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        # the encoder-decoder, the hybrid and xlstm, built and run on the CPU
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build\n"
        "from repro_torch.models.params import init_params\n"
        "for a in ('whisper_base', 'zamba2_2p7b', 'xlstm_1p3b'):\n"
        "    cfg = get_config(a, smoke=True)\n"
        "    m = build(cfg)\n"
        "    p = init_params(m.schema(), seed=0, device='cpu')\n"
        "    b = {'tokens': torch.ones((1, 4), dtype=torch.long)}\n"
        "    if cfg.family == 'encdec':\n"
        "        b['frames'] = torch.zeros((1, cfg.encoder_frames, "
        "cfg.d_model))\n"
        "    m.prefill(p, b, 8)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=240,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", ["repro_torch.dist.sharding",
                                    "repro_torch.dist.tp",
                                    "repro_torch.dist.pipeline",
                                    "repro_torch.dist.seq",
                                    "repro_torch.dist.serving",
                                    "repro_torch.launch.mesh"])
def test_distributed_layer_is_held_to_the_same_rules(module):
    """The distributed layer's modules are among those imported above
    (no jax, no reference) and scanned below."""
    assert module in _modules()
    path = PKG.joinpath(*module.split(".")[1:]).with_suffix(".py")
    assert "import jax" not in path.read_text()


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path}:{node.lineno} imports {name}")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_cpu(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as cli
    from repro_torch.models import build
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.paged_engine import (PagedEngineConfig,
                                                PagedServeEngine)
    cfg = get_config("h2o_danube_1p8b", smoke=True)
    model = build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(model.schema(), seed=0)
    params = init_params(model.schema(), seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedServeEngine(model, params, cfg, PagedEngineConfig())
    tree = {"x": np.zeros(1)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(tree, cfg, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--paged"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, params, cfg, EngineConfig())
    # asked for by name, the CPU runs (the kernels' plain versions)
    PagedServeEngine(model, params, cfg, PagedEngineConfig(), device="cpu")
    ServeEngine(model, params, cfg, EngineConfig(), device="cpu")


def test_training_entry_points_refuse_to_fall_back_to_cpu(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train as cli
    from repro_torch.models import build
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_state
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = get_config("h2o_danube_1p8b", smoke=True)
    model = build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(model, 0, OptimizerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(model, cfg, ShapeConfig("t", "train", 8, 1),
              TrainerConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--steps", "1"])
    # asked for by name, the CPU trains (the kernels' plain versions)
    _, hist = train(model, cfg, ShapeConfig("t", "train", 8, 1),
                    TrainerConfig(total_steps=1), device="cpu")
    assert len(hist) == 1


def test_cli_serves_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve as cli
    out = cli.main(["--paged", "--device", "cpu", "--requests", "3",
                    "--max-new", "4"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 4 for v in out.values())
    assert "danube-smoke on cpu" in capsys.readouterr().out
    # without --paged the lock-step engine serves, at a temperature too
    out = cli.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                    "--temperature", "0.8"])
    assert sorted(out) == [0, 1, 2]
    assert all(1 <= len(v) <= 4 for v in out.values())


@pytest.mark.parametrize("arch", ["granite_moe_1b", "deepseek_v2_236b",
                                  "minicpm3_4b"])
def test_cli_serves_moe_and_mla_on_cpu(arch, capsys):
    from repro_torch.launch import serve as cli
    for paged in (["--paged"], []):
        out = cli.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                        "--max-new", "3"] + paged)
        assert sorted(out) == [0, 1]
        assert all(len(v) == 3 for v in out.values())
    assert "-smoke on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper_base", "zamba2_2p7b"])
def test_cli_serves_encdec_and_hybrid_on_cpu(arch, capsys):
    from repro_torch.launch import serve as cli
    for paged in (["--paged"], []):
        out = cli.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                        "--max-new", "3"] + paged)
        assert sorted(out) == [0, 1, 2]
        assert all(len(v) == 3 for v in out.values())
    assert "-smoke on cpu" in capsys.readouterr().out


def test_cli_serves_xlstm_on_cpu(capsys):
    """Each request ends at its 3 new tokens or at the EOS id (1), which
    the smoke model's seeded weights emit for one request on the
    lock-step engine."""
    from repro_torch.launch import serve as cli
    for paged in (["--paged"], []):
        out = cli.main(["--arch", "xlstm_1p3b", "--device", "cpu",
                        "--requests", "3", "--max-new", "3"] + paged)
        assert sorted(out) == [0, 1, 2]
        for v in out.values():
            assert 1 not in v[:-1]
            assert len(v) == 3 or (len(v) < 3 and v[-1] == 1)
    assert "xlstm-smoke on cpu" in capsys.readouterr().out


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Run without a card (or alone, without the package beside it), the
    card check fails with a non-zero exit and prints no result."""
    for script in (ROOT / "chip_smoke.py",
                   tmp_path / "chip_smoke.py"):
        if script.parent == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
