"""The port's analytic roofline against the reference's
``repro.roofline`` on the CPU: every count equal for every arch x shape
on the reference's production meshes and a (seq 4) ring, the parameter
count without allocating, the roofline terms equal under the reference's
peaks, the H100's data-sheet peaks in ``hw``, the OISMA engine's
projection equal, and the per-layer FLOP formula within the reference's
25% of what ``torch.utils.flop_counter`` counts on the port's layer.
"""
import dataclasses
import sys

import pytest

from _torch_tests import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import param_count as jparam_count  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro.roofline import hw as jhw  # noqa: E402
from repro.roofline import model as jrm  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: E402
                                      get_config, shape_applicable)
from repro_torch.models import build  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.roofline import analysis as tan  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.roofline import model as trm  # noqa: E402

from test_torch_sim import same  # noqa: E402

#: mesh keyword sets: the reference's two production meshes, a ring, and
#: a pipelined TP mesh
MESHES = {"single_pod": dict(pod=1, data=16, model=16),
          "multi_pod": dict(pod=2, data=16, model=16),
          "seq4": dict(seq=4),
          "stage2_model2": dict(data=2, model=2, stage=2)}
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
ADMITTED = [(a, s) for a, s in CELLS
            if shape_applicable(get_config(a), SHAPES[s])[0]]


def _pair(arch):
    return get_config(arch), jget(arch)


def test_production_meshes_are_the_references():
    assert trm.SINGLE_POD.axes == tuple(
        trm.MeshAxis(a.name, a.size, a.role) for a in jrm.SINGLE_POD.axes)
    assert [(a.name, a.size, a.role) for a in trm.MULTI_POD.axes] == \
        [(a.name, a.size, a.role) for a in jrm.MULTI_POD.axes]
    for kw in MESHES.values():
        t, j = trm.MeshSpec(**kw), jrm.MeshSpec(**kw)
        assert (t.chips, t.dp, t.weight_shards, t.seq, t.stage) == \
            (j.chips, j.dp, j.weight_shards, j.seq, j.stage)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_on_every_shape_and_mesh(arch):
    cfg, jcfg = _pair(arch)
    assert trm.param_bytes(cfg) == jrm.param_bytes(jcfg)
    for s in SHAPES:
        shape, jshape = SHAPES[s], JSHAPES[s]
        got = trm.matmul_inventory(cfg, shape)
        want = jrm.matmul_inventory(jcfg, jshape)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            same(a, b)
        for remat in (True, False):
            assert trm.cell_flops(cfg, shape, remat=remat) == \
                jrm.cell_flops(jcfg, jshape, remat=remat)
        assert trm.cell_flops(cfg, shape, mm_mult=8.0) == \
            jrm.cell_flops(jcfg, jshape, mm_mult=8.0)
        for b, length in ((1, 7), (shape.global_batch, shape.seq_len)):
            assert trm.kv_cache_bytes(cfg, b, length) == \
                jrm.kv_cache_bytes(jcfg, b, length)
        for kw in MESHES.values():
            tm, jm = trm.MeshSpec(**kw), jrm.MeshSpec(**kw)
            for accum in (1, 4):
                assert trm.cell_hbm_bytes(cfg, shape, tm, accum=accum) == \
                    jrm.cell_hbm_bytes(jcfg, jshape, jm, accum=accum)
                assert trm.cell_collective_bytes(cfg, shape, tm,
                                                 accum=accum) == \
                    jrm.cell_collective_bytes(jcfg, jshape, jm, accum=accum)
                for dp_only in (False, True):
                    assert trm.memory_budget_per_device(
                        cfg, shape, tm, accum=accum, dp_only=dp_only) == \
                        jrm.memory_budget_per_device(
                            jcfg, jshape, jm, accum=accum, dp_only=dp_only)


@pytest.mark.parametrize("mode", ["bp8", "bp8_lowrank", "bp8_fused"])
def test_matmul_mode_multiplier_equal(mode):
    cfg, jcfg = _pair("h2o_danube_1p8b")
    cfg = dataclasses.replace(cfg, matmul_mode=mode)
    jcfg = dataclasses.replace(jcfg, matmul_mode=mode)
    assert trm.matmul_mode_mult(cfg) == jrm.matmul_mode_mult(jcfg)
    for s in SHAPES:
        assert trm.cell_flops(cfg, SHAPES[s]) == \
            jrm.cell_flops(jcfg, JSHAPES[s])


def test_param_count_allocates_nothing(monkeypatch):
    """``param_count`` reads shapes only: with every ``init_params`` of
    the port patched to raise it still counts the full configs (qwen2-72b,
    the whole deepseek-v2-236b) equal to the reference's."""
    def refuse(*a, **k):
        raise AssertionError("param_count must not build parameters")
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch") and hasattr(mod, "init_params"):
            monkeypatch.setattr(mod, "init_params", refuse)
    for arch in ARCH_IDS:
        cfg, jcfg = _pair(arch)
        got = tparams.param_count(build(cfg).schema())
        assert got == jparam_count(jbuild(jcfg).schema())
        assert trm.param_bytes(cfg) == 2 * got
        assert tan.model_flops_estimate(cfg, SHAPES["train_4k"]) == \
            jan.model_flops_estimate(jcfg, JSHAPES["train_4k"])
    assert tparams.param_count(build(get_config("deepseek_v2_236b"))
                               .schema()) > 230e9


def test_hw_holds_the_h100_data_sheet_peaks():
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_OPS_INT8 == 1979e12
    assert hw.PEAK_FLOPS_F32 == 67e12
    assert hw.HBM_BW == 3.35e12
    assert hw.NVLINK_BW == 450e9
    t = tan.RooflineTerms(flops=1e15, hbm_bytes=1e12,
                          coll_bytes_per_chip=1e9, chips=8, model_flops=5e14)
    assert t.t_compute == 1e15 / (8 * 989e12)
    assert t.t_memory == 1e12 / (8 * 3.35e12)
    assert t.t_collective == 1e9 / 450e9


@pytest.fixture
def reference_peaks(monkeypatch):
    monkeypatch.setattr(hw, "PEAK_FLOPS_BF16", jhw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hw, "HBM_BW", jhw.HBM_BW)
    monkeypatch.setattr(hw, "NVLINK_BW", jhw.ICI_BW_PER_LINK)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_roofline_terms_equal_under_the_references_peaks(mesh,
                                                         reference_peaks):
    kw = MESHES[mesh]
    for arch, s in CELLS:
        cfg, jcfg = _pair(arch)
        for bubble in (0.0, 0.25):
            got = trm.analytic_cell(cfg, SHAPES[s], trm.MeshSpec(**kw),
                                    accum=2, pipeline_bubble=bubble)
            want = jrm.analytic_cell(jcfg, JSHAPES[s], jrm.MeshSpec(**kw),
                                     accum=2, pipeline_bubble=bubble)
            assert got["terms"].as_dict() == want["terms"].as_dict()
            for k in ("flops", "hbm", "coll"):
                assert got[k] == want[k]


@pytest.mark.parametrize("arch,shape", ADMITTED,
                         ids=[f"{a}-{s}" for a, s in ADMITTED])
def test_oisma_engine_projection_equal(arch, shape):
    cfg, jcfg = _pair(arch)
    for engines in (1, 4):
        assert trm.oisma_engine_projection(cfg, SHAPES[shape],
                                           engines=engines) == \
            jrm.oisma_engine_projection(jcfg, JSHAPES[shape], engines=engines)
    kw = dict(technology_nm=180, double_buffered=False, include_attention=True)
    assert trm.oisma_engine_projection(cfg, SHAPES[shape], **kw) == \
        jrm.oisma_engine_projection(jcfg, JSHAPES[shape], **kw)


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b"])
def test_formula_matches_flop_counter_per_layer(arch):
    """The reference's ``test_formula_matches_xla_per_layer`` on the port:
    one smoke-width layer in bf16, its FLOPs counted by
    ``torch.utils.flop_counter`` on the CPU, within 25% of the formula at
    the average causal kv length (the counter sees matmuls and attention;
    the formula ignores the elementwise work)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.model import (_decoder_layer_apply,
                                          _decoder_layer_defs)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              matmul_mode="bf16")
    b, s = 2, 64
    p = tparams.init_params(_decoder_layer_defs(cfg, cfg.num_experts > 0),
                            seed=0, device="cpu")
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    positions = torch.arange(s)[None].expand(b, s)
    with FlopCounterMode(display=False) as counter:
        _decoder_layer_apply(p, cfg, x, positions, window=s + 1)
    got = counter.get_total_flops()
    want = b * s * trm.fwd_flops_per_layer_tok(cfg, 0, (s + 1) / 2)
    assert want == b * s * jrm.fwd_flops_per_layer_tok(jget(arch, smoke=True),
                                                       0, (s + 1) / 2)
    assert got == pytest.approx(want, rel=0.25), (got, want)
