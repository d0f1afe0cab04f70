"""The port stands alone: it imports neither jax nor the reference
package, and its entry points never carry on silently on the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=240,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


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
