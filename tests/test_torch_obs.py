"""The port's observability layer against the reference's, on the CPU.

* the port's copies of the registry, the tracer and the watchdog pass the
  reference's own cases (``tests/test_obs.py``, run with the port's
  classes in place of the reference's);
* the simulator's two adapters render the port's round walks and tile
  traces as Chrome documents equal to the reference's, and the
  ``utils.metrics`` shim is the port's JSONL logger;
* under one ``FakeClock`` injected into both tracers, the port's paged
  engine and the reference's, serving the same requests with a
  ``Tracer``, a registry and a watchdog, give equal Chrome-trace event
  lists (names, phases, lanes, args, and the fake timestamps), equal
  registry snapshots and equal watchdog reports.
"""
import inspect

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import test_obs as cases  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402

from test_torch_serve import EXACT, configs, to_np  # noqa: E402

PORTED = ("JsonlLogger", "MetricsRegistry", "Observability", "RetraceError",
          "RetraceWatchdog", "Tracer", "percentile", "read_metrics")
#: the reference's cases of the registry, logger, tracer and watchdog
CASES = [name for name, fn in inspect.getmembers(cases, inspect.isfunction)
         if name.startswith("test_")
         and inspect.getsourcelines(fn)[1] < inspect.getsourcelines(
             cases.test_round_timeline_matches_matmul_report)[1]
         and name != "test_utils_metrics_shim_is_the_obs_logger"]


def test_cases_cover_the_ported_surface():
    assert len(CASES) == 18
    assert callable(tobs.round_walk_chrome_trace)
    assert callable(tobs.sim_chrome_trace)


def test_utils_metrics_shim_is_the_obs_logger():
    from repro_torch.utils.metrics import (MetricsLogger, read_metrics,
                                           step_time_summary)
    assert MetricsLogger is tobs.JsonlLogger
    assert read_metrics is tobs.read_metrics
    assert step_time_summary is tobs.step_time_summary


@pytest.mark.parametrize("double_buffered", [False, True])
@pytest.mark.parametrize("stationary", [False, True])
def test_round_walk_chrome_trace_equals_the_reference(double_buffered,
                                                      stationary):
    from repro.sim import mapper as jmapper
    from repro_torch.sim import mapper as tmapper
    kw = dict(banks=4, arrays_per_bank=2, write_ports_per_bank=1,
              double_buffered=double_buffered)
    for m, k, n in ((64, 2048, 512), (16, 700, 130), (512, 2048, 1024)):
        tsl = tmapper.round_timeline(m, k, n, tmapper.EngineConfig(**kw),
                                     stationary=stationary)
        jsl = jmapper.round_timeline(m, k, n, jmapper.EngineConfig(**kw),
                                     stationary=stationary)
        for freq in (None, 372e6):
            got = tobs.round_walk_chrome_trace(tsl, name="qkv", freq_hz=freq)
            want = jobs.round_walk_chrome_trace(jsl, name="qkv",
                                                freq_hz=freq)
            assert got == want
            assert any(e["ph"] == "X" for e in got["traceEvents"])


@pytest.mark.parametrize("freq", [None, 50e6])
def test_sim_chrome_trace_equals_the_reference(freq):
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPES as JSHAPES
    from repro.sim import map_model as jmap_model, Trace as JTrace
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.sim import map_model, Trace
    tt, jt = Trace(), JTrace()
    map_model(get_config("granite_moe_1b"), SHAPES["decode_32k"], trace=tt,
              include_attention=True)
    jmap_model(jget("granite_moe_1b"), JSHAPES["decode_32k"], trace=jt,
               include_attention=True)
    got = tobs.sim_chrome_trace(tt, freq_hz=freq)
    want = jobs.sim_chrome_trace(jt, freq_hz=freq)
    assert got == want
    assert sum(e["ph"] == "X" for e in got["traceEvents"]) == len(tt)


@pytest.mark.parametrize("case", CASES)
def test_port_passes_reference_case(case, monkeypatch, tmp_path):
    for name in PORTED:
        monkeypatch.setattr(cases, name, getattr(tobs, name))
    fn = getattr(cases, case)
    fn(*[tmp_path for _ in inspect.signature(fn).parameters])


@pytest.fixture(scope="module")
def served():
    """Both paged engines, instrumented, serving 4 requests (more than the
    2 slots, so admission happens mid-stream) with one fake clock each."""
    jcfg, tcfg = configs("h2o_danube_1p8b")
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 9, 3)]
    kw = dict(slots=2, block_size=8, num_blocks=32, max_prefill_tokens=8,
              temperature=0.8)

    def obs_of(mod):
        reg = mod.MetricsRegistry()
        return mod.Observability(registry=reg,
                                 tracer=mod.Tracer(cases.FakeClock()),
                                 watchdog=mod.RetraceWatchdog(reg))

    jo = obs_of(jobs)
    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**kw),
                              obs=jo)
    limits = je.compile_shape_bounds()
    je._decode = jo.watchdog.watch(
        jax.jit(jm.decode_step, compiler_options=EXACT), "decode_step",
        limit=limits["decode_step"])
    je._prefill_chunk = jo.watchdog.watch(
        jax.jit(jm.prefill_chunk, compiler_options=EXACT), "prefill_chunk",
        limit=limits["prefill_chunk"])
    want = je.run([jpe.PagedRequest(rid=i, prompt=p, max_new_tokens=6,
                                    priority=i % 2)
                   for i, p in enumerate(prompts)], seed=3)
    to = obs_of(tobs)
    te = tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(**kw),
                              device="cpu", obs=to)
    got = te.run([tpe.PagedRequest(rid=i, prompt=p, max_new_tokens=6,
                                   priority=i % 2)
                  for i, p in enumerate(prompts)], seed=3)
    assert got == want
    return jo, to, te


def test_paged_engine_trace_matches_reference(served):
    jo, to, _ = served
    jev = jo.tracer.chrome_trace()["traceEvents"]
    tev = to.tracer.chrome_trace()["traceEvents"]
    key = lambda e: (e["name"], e["ph"], e["tid"], e.get("args"))
    assert [key(e) for e in tev] == [key(e) for e in jev]
    assert tev == jev                      # the fake timestamps too
    names = {e["name"] for e in tev}
    assert {"engine_step", "prefill_chunk", "decode_tick", "submit",
            "admit", "retire", "blocks_in_use"} <= names
    assert {e["tid"] for e in tev if e["name"] == "prefill_chunk"} == {1, 2}
    assert to.tracer.open_spans() == 0


def test_paged_engine_registry_and_watchdog_match_reference(served):
    jo, to, te = served
    assert to.registry.snapshot() == jo.registry.snapshot()
    assert to.watchdog.report() == jo.watchdog.report()
    bounds = te.compile_shape_bounds()
    for name, rep in to.watchdog.report().items():
        assert rep["compiled"] == te.compile_counts()[name]
        assert rep["compiled"] <= bounds[name] == rep["limit"]
        assert to.registry.value("jit_compiled_shapes",
                                 callsite=name) == rep["compiled"]
    to.watchdog.assert_ok()
    assert to.registry.value("serve.completed_requests") == 4
    assert to.registry.value("serve.submitted_requests") == 4


def test_watchdog_bounds_the_engine_live():
    """A watchdog limit below what the engine needs stops it mid-run."""
    _, tcfg = configs("h2o_danube_1p8b")
    tm = build(tcfg)
    from repro_torch.models.params import init_params
    obs = tobs.Observability.make(watchdog_limit=1)
    eng = tpe.PagedServeEngine(tm, init_params(tm.schema(), 0, "cpu"), tcfg,
                               tpe.PagedEngineConfig(max_prefill_tokens=8),
                               device="cpu", obs=obs)
    with pytest.raises(tobs.RetraceError, match="prefill_chunk"):
        eng.run([tpe.PagedRequest(rid=0, prompt=np.arange(3, 16,
                                                          dtype=np.int32),
                                  max_new_tokens=2)])


def test_engine_without_obs_records_nothing():
    _, tcfg = configs("h2o_danube_1p8b")
    tm = build(tcfg)
    from repro_torch.models.params import init_params
    eng = tpe.PagedServeEngine(tm, init_params(tm.schema(), 0, "cpu"), tcfg,
                               tpe.PagedEngineConfig(), device="cpu")
    assert eng.obs is None and eng._run_decode is eng._decode
    assert eng._run_prefill is eng._prefill
