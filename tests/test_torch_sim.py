"""The port's OISMA cost model and engine simulator against the
reference's ``repro.core.oisma_cost`` and ``repro.sim``, on the CPU.

Both are pure Python with the same expressions in the same order, so
every report is held equal with ``==``: each dataclass field by field
(``dataclasses.asdict``) and each derived property, floats included.
"""
import dataclasses
import inspect

import pytest
from _compat import given, settings, st

from _torch_tests import torch  # noqa: F401,E402

import repro.sim as jsim  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import oisma_cost as joc  # noqa: E402
from repro.roofline import model as jrm  # noqa: E402
from repro.sim import mapper as jmapper  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: E402
                                      get_config, shape_applicable)
from repro_torch.core import oisma_cost as toc  # noqa: E402
from repro_torch.roofline import model as trm  # noqa: E402
from repro_torch.sim import mapper as tmapper  # noqa: E402

#: the reference's brute-force grid (tests/test_sim.py)
GRID = [(1, 1, 1), (7, 128, 32), (16, 129, 33), (4, 1000, 100),
        (64, 257, 95)]
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])[0]]


def _props(obj):
    return sorted(n for n, v in inspect.getmembers(type(obj))
                  if isinstance(v, property))


def same(got, want):
    """Equal field by field and property by property, recursively through
    tuples of reports."""
    assert type(got).__name__ == type(want).__name__
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert _props(got) == _props(want)
        for name in _props(want):
            g, w = getattr(got, name), getattr(want, name)
            if dataclasses.is_dataclass(w):
                same(g, w)
            else:
                assert g == w, (type(want).__name__, name, g, w)
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if isinstance(w, tuple) and w and dataclasses.is_dataclass(w[0]):
                for a, b in zip(getattr(got, f.name), w, strict=True):
                    same(a, b)
    else:
        assert got == want


@pytest.mark.parametrize("tech", [180, 22])
@pytest.mark.parametrize("arrays", [1, 4, 256])
def test_matmul_cost_and_comparison_table_equal(tech, arrays):
    for m, k, n in GRID + [(4096, 4096, 8192), (3, 70000, 5)]:
        for stat in (True, False):
            got = toc.matmul_cost(m, k, n, toc.OISMAConfig(tech, arrays),
                                  input_stationary=stat)
            want = joc.matmul_cost(m, k, n, joc.OISMAConfig(tech, arrays),
                                   input_stationary=stat)
            same(got, want)
    same(toc.OISMAConfig(tech, arrays), joc.OISMAConfig(tech, arrays))
    assert toc.comparison_table() == joc.comparison_table()
    names = [n for n in dir(joc) if n.isupper()]
    assert {n: getattr(toc, n) for n in names} == \
        {n: getattr(joc, n) for n in names}


def test_validate_rows_equal_and_under_half_percent():
    got, want = tsim.validate(), jsim.validate()
    assert got == want
    assert len(got) == 7
    for metric, sim, ref, rel in got:
        assert rel < 0.005, (metric, sim, ref, rel)
    assert tsim.vmm_saving_fraction() == jsim.vmm_saving_fraction()


@pytest.mark.parametrize("m,k,n", GRID)
@pytest.mark.parametrize("dataflow", ["vmm", "single"])
@pytest.mark.parametrize("stationary", [True, False])
def test_map_matmul_equal_on_the_reference_grid(m, k, n, dataflow,
                                                stationary):
    for extra in ({}, {"double_buffered": True, "write_ports_per_bank": 1},
                  {"count_initial_programming": True},
                  {"free_programming": True, "technology_nm": 22}):
        kw = dict(banks=2, arrays_per_bank=2, dataflow=dataflow, **extra)
        for count in (1.0, 3.0, 0.5):
            same(tmapper.map_matmul(m, k, n, tsim.EngineConfig(**kw),
                                    stationary=stationary, count=count),
                 jmapper.map_matmul(m, k, n, jsim.EngineConfig(**kw),
                                    stationary=stationary, count=count))


@given(m=st.floats(0.25, 48.0), k=st.integers(1, 600),
       n=st.integers(1, 150), banks=st.integers(1, 3),
       apb=st.integers(1, 4), ports=st.integers(0, 3),
       count=st.sampled_from([1.0, 2.0, 0.75]),
       dataflow=st.sampled_from(["vmm", "single"]),
       stationary=st.booleans(), db=st.booleans(), tech=st.sampled_from(
           [180, 22]))
@settings(max_examples=25, deadline=None)
def test_map_matmul_equal_property(m, k, n, banks, apb, ports, count,
                                   dataflow, stationary, db, tech):
    kw = dict(banks=banks, arrays_per_bank=apb, write_ports_per_bank=ports,
              dataflow=dataflow, double_buffered=db, technology_nm=tech)
    tt, jt = tsim.Trace(), jsim.Trace()
    same(tmapper.map_matmul(m, k, n, tsim.EngineConfig(**kw), name="p",
                            stationary=stationary, count=count, trace=tt),
         jmapper.map_matmul(m, k, n, jsim.EngineConfig(**kw), name="p",
                            stationary=stationary, count=count, trace=jt))
    assert tt.summarize() == jt.summarize()
    assert [dataclasses.asdict(e) for e in tt.events] == \
        [dataclasses.asdict(e) for e in jt.events]
    for a, b in zip(tmapper.round_timeline(m, k, n, tsim.EngineConfig(**kw),
                                           stationary=stationary),
                    jmapper.round_timeline(m, k, n, jsim.EngineConfig(**kw),
                                           stationary=stationary),
                    strict=True):
        same(a, b)


@pytest.mark.parametrize("double_buffered", [False, True])
@pytest.mark.parametrize("stationary", [False, True])
def test_round_timeline_slices_equal(double_buffered, stationary):
    kw = dict(banks=4, arrays_per_bank=4, double_buffered=double_buffered,
              write_ports_per_bank=2)
    for m, k, n in ((64, 1024, 512), (16, 700, 130), (128, 256, 64),
                    (512, 2048, 1024)):
        got = tmapper.round_timeline(m, k, n, tsim.EngineConfig(**kw),
                                     stationary=stationary)
        want = jmapper.round_timeline(m, k, n, jsim.EngineConfig(**kw),
                                      stationary=stationary)
        assert got and len(got) == len(want)
        for a, b in zip(got, want):
            same(a, b)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_map_model_equal_on_every_cell(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    for kw in ({}, {"technology_nm": 22, "double_buffered": True}):
        tt, jt = tsim.Trace(), jsim.Trace()
        got = tsim.map_model(cfg, SHAPES[shape], tsim.EngineConfig(**kw),
                             trace=tt)
        want = jsim.map_model(jcfg, _ref_shape(shape), jsim.EngineConfig(**kw),
                              trace=jt)
        same(got, want)
        assert tt.summarize() == jt.summarize()
    same(tsim.map_model(cfg, SHAPES[shape], include_attention=True),
         jsim.map_model(jcfg, _ref_shape(shape), include_attention=True))


def _ref_shape(name):
    from repro.configs.base import SHAPES as JSHAPES
    return JSHAPES[name]


def _inventory(arch="h2o_danube_1p8b", shape="decode_32k"):
    return (trm.matmul_inventory(get_config(arch), SHAPES[shape]),
            jrm.matmul_inventory(jget(arch), _ref_shape(shape)))


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b",
                                  "whisper_base", "granite_moe_1b"])
def test_cluster_reports_equal(arch):
    tinv, jinv = _inventory(arch)
    for db in (False, True):
        te = tsim.EngineConfig(technology_nm=22, double_buffered=db)
        je = jsim.EngineConfig(technology_nm=22, double_buffered=db)
        for e in (1, 2, 4, 8):
            tc = tsim.ClusterConfig(engines=e, engine=te)
            jc = jsim.ClusterConfig(engines=e, engine=je)
            for t_ent, j_ent in zip(tinv, jinv, strict=True):
                same(tsim.shard_matmul(t_ent, tc, floor_cycles=(3.0, 5.0)),
                     jsim.shard_matmul(j_ent, jc, floor_cycles=(3.0, 5.0)))
            same(tsim.map_cluster(tinv, tc, include_attention=False),
                 jsim.map_cluster(jinv, jc, include_attention=False))
        got = tsim.scaling_curve(tinv, te)
        want = jsim.scaling_curve(jinv, je)
        assert [e for e, _ in got] == [e for e, _ in want] == [1, 2, 4, 8, 16]
        for (_, a), (_, b) in zip(got, want):
            same(a, b)
    # a K-spill and idle engines
    for entry in (("narrow", 64, 4096, 32), ("tiny", 8, 64, 16)):
        cc = (tsim.ClusterConfig(engines=4), jsim.ClusterConfig(engines=4))
        same(tsim.map_cluster([trm.MatmulShape(*entry)], cc[0]),
             jsim.map_cluster([jrm.MatmulShape(*entry)], cc[1]))


def test_map_workload_and_trace_summary_equal():
    tinv, jinv = _inventory("deepseek_v2_236b", "prefill_32k")
    tt, jt = tsim.Trace(), jsim.Trace()
    same(tsim.map_workload(tinv, trace=tt),
         jsim.map_workload(jinv, trace=jt))
    assert len(tt) == len(jt) > 0
    assert tt.summarize() == jt.summarize()
    same(tt.total(), jt.total())
    assert [e.as_row() for e in tt.events] == [e.as_row() for e in jt.events]
