"""The port's fault tolerance on the CPU: crash and resume bitwise, the
failure injector, the straggler monitor, the supervisors, async
checkpoint writes overlapping training, and the training launcher.

The cases mirror ``tests/test_fault_tolerance.py``; the trainer is the
port's, on the h2o-danube smoke config.  The chaos test of a SIGKILLed
8-device run resuming on another mesh carving waits for the port's
distributed layer.  Tolerances: none — resumed loss curves are bitwise
those of an uninterrupted run.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

from _compat import given, settings, st  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    ChaosSupervisor, FailureInjector, InjectedFailure, KillSpec,
    StragglerMonitor, Supervisor, final_loss_history)
from repro_torch.train.trainer import TrainerConfig, train  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPE = ShapeConfig("t", "train", 32, 2)
OPT = OptimizerConfig(learning_rate=3e-3, warmup_steps=2, total_steps=8)


@pytest.fixture(scope="module")
def small():
    cfg = get_config("h2o_danube_1p8b", smoke=True)
    return cfg, build(cfg)


def test_crash_resume_identical_losses(tmp_path, small):
    """8 steps with a crash at step 5 and auto-resume: the losses after
    recovery are bitwise those of an uninterrupted run, and so is the
    final state."""
    cfg, model = small
    ref_state, ref = train(model, cfg, SHAPE,
                           TrainerConfig(total_steps=8, ckpt_dir=None),
                           opt_cfg=OPT, device="cpu")
    metrics = str(tmp_path / "m.jsonl")
    tc = TrainerConfig(total_steps=8, ckpt_every=2, metrics_path=metrics,
                       ckpt_dir=str(tmp_path / "ckpt"))
    inj = FailureInjector(fail_at_steps=(5,))
    runs = []

    def run():
        state, hist = train(model, cfg, SHAPE, tc, opt_cfg=OPT,
                            injector=inj, device="cpu")
        runs.append((state, hist))
        return hist[-1]["step"] if hist else 0

    out = Supervisor(max_restarts=2).run(run)
    assert out == {"final_step": 8, "restarts": 1}
    state, hist = runs[-1]
    assert hist[0]["step"] == 5           # resumed from the step-4 save
    got = final_loss_history(metrics)
    assert got == {h["step"]: h["loss"] for h in ref}
    for (_, a), (_, b) in zip(tree_leaves(state), tree_leaves(ref_state)):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 8


def test_resume_refuses_another_data_stream(tmp_path, small):
    cfg, model = small
    d = str(tmp_path / "ckpt")
    train(model, cfg, SHAPE, TrainerConfig(total_steps=2, ckpt_every=1,
                                           ckpt_dir=d),
          opt_cfg=OPT, device="cpu")
    with pytest.raises(ValueError, match="data geometry"):
        train(model, cfg, ShapeConfig("t", "train", 32, 4),
              TrainerConfig(total_steps=3, ckpt_dir=d), opt_cfg=OPT,
              device="cpu")


def test_checkpoint_payload_is_the_references(tmp_path, small):
    """The payload's ``extra``: the data geometry as int64 and the seed's
    key as ``jax.random.key_data(jax.random.key(seed))`` (uint32)."""
    cfg, model = small
    d = str(tmp_path / "ckpt")
    train(model, cfg, SHAPE, TrainerConfig(total_steps=1, ckpt_dir=d,
                                           seed=7),
          opt_cfg=OPT, device="cpu")
    man = ckpt.read_manifest(d, 1)
    assert man["treedef"].startswith(
        "PyTreeDef({'extra': {'data': *, 'rng': *}, 'state': {'opt': {'m': ")
    data, rng = man["leaves"][:2]
    assert (data["dtype"], data["shape"]) == ("int64", [4])
    assert (rng["dtype"], rng["shape"]) == ("uint32", [2])
    step_dir = os.path.join(d, "step_000000001")
    np.testing.assert_array_equal(
        np.load(os.path.join(step_dir, data["file"])), [7, 1, 2, 32])
    np.testing.assert_array_equal(
        np.load(os.path.join(step_dir, rng["file"])), [0, 7])


def test_checkpoint_write_overlaps_training(tmp_path, small):
    cfg, model = small
    obs = Observability.make(trace=True)
    train(model, cfg, SHAPE,
          TrainerConfig(total_steps=6, ckpt_every=2,
                        ckpt_dir=str(tmp_path / "ckpt"),
                        ckpt_write_throttle_s=0.3),
          opt_cfg=OPT, obs=obs, device="cpu")
    spans = [e for e in obs.tracer.events if e.ph == "X"]
    steps = [e for e in spans if e.name == "train_step"]
    writes = [e for e in spans if e.name == "ckpt.write"]
    assert steps and writes

    def overlap(a, b):
        return a.ts < b.ts + b.dur and b.ts < a.ts + a.dur
    assert any(overlap(w, s) for w in writes for s in steps)
    assert any(w.tid != 0 for w in writes)
    reg = obs.registry
    assert reg.value("train.steps") == 6
    assert reg.value("train.checkpoints") == 4     # steps 2, 4, 6 + final


def test_trainer_refuses_a_mesh(small):
    """The decoders train on a mesh (``tests/test_torch_dist_train.py``);
    the other families refuse a stage mesh, as the reference's fail
    there (their models have no ``pipeline_loss``), before any rank
    work."""
    import types
    mesh = types.SimpleNamespace(shape={"stage": 2, "data": 1, "model": 1})
    for arch in ("whisper_base", "zamba2_2p7b", "xlstm_1p3b"):
        cfg = get_config(arch, smoke=True)
        with pytest.raises(NotImplementedError, match="stage mesh.*5c"):
            train(build(cfg), cfg, SHAPE, TrainerConfig(total_steps=1),
                  mesh=mesh, device="cpu")


def test_launcher_trains_on_cpu_and_refuses_shards(tmp_path, capsys):
    from repro_torch.launch import train as cli
    out = cli.main(["--device", "cpu", "--steps", "3", "--seq-len", "16",
                    "--global-batch", "2", "--matmul-mode", "bp8",
                    "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "2",
                    "--fail-at", "2"])
    assert out == 3
    text = capsys.readouterr().out
    assert "danube-smoke (2 layers, bp8) on cpu" in text
    assert "finished at step 3 after 1 restart(s)" in text
    # --model-shards 2: two gloo ranks of the launcher's own, resuming
    # the run above (its checkpoint of step 3) on a model mesh to step 5
    out = cli.main(["--device", "cpu", "--model-shards", "2", "--steps",
                    "5", "--seq-len", "16", "--global-batch", "2",
                    "--matmul-mode", "bp8", "--ckpt-dir",
                    str(tmp_path / "c"), "--ckpt-every", "2"])
    assert out == 5
    # a rank's failure fails the launch: xlstm refuses a stage mesh
    with pytest.raises(RuntimeError, match="stage mesh"):
        cli.main(["--device", "cpu", "--arch", "xlstm_1p3b",
                  "--model-shards", "1", "--stages", "2", "--steps", "1"])


def test_launcher_trains_moe_on_cpu(capsys):
    from repro_torch.launch import train as cli
    out = cli.main(["--arch", "granite_moe_1b", "--device", "cpu",
                    "--steps", "2", "--seq-len", "16", "--global-batch", "2",
                    "--matmul-mode", "bp8"])
    assert out == 2
    assert "granite-moe-smoke (2 layers, bp8) on cpu" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# injector, straggler monitor, supervisor (the reference's cases)
# ---------------------------------------------------------------------------

def test_injector_fires_once():
    inj = FailureInjector(fail_at_steps=(3,))
    inj.maybe_fail(2)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(patience=2)
    for s in range(20):
        mon.observe(s, 0.1 + 0.001 * (s % 3))
    flagged = False
    for s in range(20, 24):
        flagged |= mon.observe(s, 2.0)
    assert flagged and mon.flagged


def _numpy_ema(samples, alpha=0.1, z=3.0):
    """Independent replica of the monitor's EMA with anomaly exclusion."""
    mean = var = 0.0
    n = 0
    for dt in samples:
        slow = n > 2 and dt > mean + z * np.sqrt(max(var, 1e-12))
        if not slow:
            d = dt - mean
            mean = mean + alpha * d
            var = (1 - alpha) * (var + alpha * d * d)
        n += 1
    return mean, np.sqrt(max(var, 0.0))


def test_straggler_ema_matches_numpy_replica():
    rng = np.random.default_rng(0)
    samples = (0.1 + 0.01 * rng.standard_normal(200)).clip(0.01).tolist()
    samples[50] = samples[120] = 5.0
    mon = StragglerMonitor()
    for s, dt in enumerate(samples):
        mon.observe(s, dt)
    mean, std = _numpy_ema(samples)
    assert mon.mean == mean and mon.std == std
    assert 0.05 < mon.mean < 0.2


def test_straggler_patience_and_streak_reset():
    mon = StragglerMonitor(patience=3)
    for s in range(10):
        mon.observe(s, 0.1)
    assert not mon.observe(10, 9.0)
    assert not mon.observe(11, 9.0)
    assert mon.observe(12, 9.0)
    assert mon.flagged == [12]
    assert not mon.observe(13, 9.0)
    baseline = StragglerMonitor(patience=1)
    for s in range(10):
        baseline.observe(s, 0.1)
    mean = baseline.mean
    baseline.observe(10, 50.0)
    assert baseline.mean == mean and baseline.flagged == [10]


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(min_value=1e-3, max_value=10.0,
                          allow_nan=False), min_size=1, max_size=100))
def test_straggler_property_matches_replica(samples):
    mon = StragglerMonitor()
    flags = [mon.observe(s, dt) for s, dt in enumerate(samples)]
    mean, std = _numpy_ema(samples)
    assert mon.mean == pytest.approx(mean, rel=1e-12)
    assert mon.std == pytest.approx(std, rel=1e-12)
    assert sum(flags) <= len(samples) // mon.patience + 1


def test_supervisor_bounds_restarts_and_filters_faults():
    calls = []

    def always_fail():
        calls.append(1)
        raise InjectedFailure("x")

    with pytest.raises(RuntimeError, match="exceeded"):
        Supervisor(max_restarts=1).run(always_fail)
    assert len(calls) == 2
    with pytest.raises(ValueError):
        Supervisor(max_restarts=3).run(
            lambda: (_ for _ in ()).throw(ValueError("real bug")))
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise OSError("transient")
        return 7

    out = Supervisor(max_restarts=3,
                     should_restart=lambda e: isinstance(e, OSError)
                     ).run(flaky)
    assert out == {"final_step": 7, "restarts": 2}


# ---------------------------------------------------------------------------
# ChaosSupervisor on a cheap child (no torch in it)
# ---------------------------------------------------------------------------

_COUNTER_CHILD = r"""
import json, os, sys, time
path, steps = sys.argv[1], int(sys.argv[2])
done = -1
if os.path.exists(path):
    with open(path) as f:
        for line in f:
            try:
                done = max(done, json.loads(line)["step"])
            except Exception:
                pass
with open(path, "a", buffering=1) as f:
    for s in range(done + 1, steps):
        f.write(json.dumps({"step": s, "loss": 1.0 / (s + 1)}) + "\n")
        time.sleep(0.03)
print("COUNTER_DONE")
"""


def test_chaos_supervisor_kills_and_restarts(tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    obs = Observability.make()
    sup = ChaosSupervisor(
        argv=[sys.executable, "-c", _COUNTER_CHILD, metrics, "30"],
        max_restarts=2, poll_s=0.01, timeout_s=60, obs=obs)
    hooks = []
    out = sup.run(lambda attempt: KillSpec(at_step=5, metrics_path=metrics)
                  if attempt == 0 else None,
                  between_attempts=hooks.append)
    assert out["restarts"] == 1
    assert len(out["kills"]) == 1 and out["kills"][0].at_step >= 5
    assert out["kills"][0].returncode != 0
    assert hooks == [1]
    assert "COUNTER_DONE" in out["stdout"][-1]
    assert sorted(final_loss_history(metrics)) == list(range(30))
    assert obs.registry.value("chaos.kills") == 1


def test_chaos_supervisor_bounds_restarts(tmp_path):
    sup = ChaosSupervisor(
        argv=[sys.executable, "-c", "import sys; sys.exit(3)"],
        max_restarts=1, timeout_s=30)
    with pytest.raises(RuntimeError, match="exceeded"):
        sup.run(lambda attempt: None)


def test_kill_spec_reads_completed_checkpoints(tmp_path):
    spec = KillSpec(at_step=2, ckpt_dir=str(tmp_path))
    assert spec.progress() == -1
    ckpt.save(str(tmp_path), 3, {"x": torch.zeros(1)})
    assert spec.progress() == 3


def test_final_loss_history_last_record_wins(tmp_path):
    p = tmp_path / "h.jsonl"
    p.write_text('{"step": 1, "loss": 5.0}\n'
                 '{"step": 2, "loss": 4.0}\n'
                 '{"step": 1, "loss": 3.0}\n'
                 '{"step": 2, "loss"')
    assert final_loss_history(str(p)) == {1: 3.0, 2: 4.0}


def test_sigkilled_trainer_resumes_bitwise(tmp_path):
    """A real training subprocess on the CPU, SIGKILLed once a checkpoint
    is complete, restarted, and its loss curve bitwise that of an
    uninterrupted run."""
    child = r"""
import sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainerConfig, train
ckpt_dir, metrics, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
cfg = get_config("h2o_danube_1p8b", smoke=True)
train(build(cfg), cfg, ShapeConfig("t", "train", 32, 2),
      TrainerConfig(total_steps=steps, ckpt_every=1, keep=3,
                    ckpt_dir=ckpt_dir or None, metrics_path=metrics,
                    ckpt_write_throttle_s=0.05),
      opt_cfg=OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                              total_steps=steps), device="cpu")
print("CHILD_DONE", flush=True)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    steps, d = 10, str(tmp_path / "ckpt")
    metrics = str(tmp_path / "chaos.jsonl")
    sup = ChaosSupervisor(argv=[sys.executable, "-c", child, d, metrics,
                                str(steps)],
                          env=env, max_restarts=2, poll_s=0.02,
                          timeout_s=300)
    out = sup.run(lambda attempt: KillSpec(at_step=3, ckpt_dir=d)
                  if attempt == 0 else None)
    assert out["restarts"] == 1 and "CHILD_DONE" in out["stdout"][-1]
    ref = str(tmp_path / "ref.jsonl")
    r = subprocess.run([sys.executable, "-c", child, "", ref, str(steps)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got, want = final_loss_history(metrics), final_loss_history(ref)
    assert sorted(got) == list(range(1, steps + 1))
    assert got == want
    with open(metrics) as f:
        logged = [json.loads(line)["step"] for line in f if line.strip()]
    assert len(logged) >= steps        # the resumed run re-logs its steps
