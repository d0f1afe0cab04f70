"""The port's traffic harness, traffic model and kernel counters against
the reference's, on the CPU.

* ``make_requests`` gives the reference's requests;
* ``summarize_lifecycle`` gives the reference's percentiles from the same
  records;
* ``run_traffic`` over the port's paged engine gives the reference's
  record, key for key, on smoke h2o-danube-1.8b (``bp8_fused`` + ``bp8``,
  the reference compiled without excess precision), 12 requests at
  offered loads 0.1 and 0.4;
* ``kernels/traffic.py`` gives the reference's dicts for the same shapes
  and blocks, and ``hopper_tiles`` the integer core's tile;
* ``_record`` counts the fused ops' eager calls, with the traffic of the
  Hopper tiles, and none inside ``paused()`` (a graph's warm-up; a call
  under CUDA-graph capture is not counted either: the gpu tests check
  that on the card).
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402

from repro.kernels import traffic as jtraffic  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro.serve import traffic as jtr  # noqa: E402
from repro_torch.kernels import metrics as tmetrics  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import traffic as ttraffic  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402
from repro_torch.serve import traffic as ttr  # noqa: E402

from test_torch_model import ref_jit  # noqa: E402
from test_torch_serve import configs, to_np  # noqa: E402

ECFG = dict(slots=4, block_size=8, num_blocks=64, max_prefill_tokens=16)


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("load", [0.1, 0.25, 0.4])
def test_make_requests_match(seed, load):
    kw = dict(num_requests=20, offered_load=load, seed=seed, vocab=512)
    want = jtr.make_requests(jtr.TrafficConfig(**kw))
    got = ttr.make_requests(ttr.TrafficConfig(**kw))
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert (g.rid, g.max_new_tokens, g.priority, g.arrival_step) == \
            (w.rid, w.max_new_tokens, w.priority, w.arrival_step)
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype
    assert dataclasses.asdict(ttr.TrafficConfig()) == \
        dataclasses.asdict(jtr.TrafficConfig())


@pytest.mark.parametrize("n", [0, 1, 2, 37])
def test_summarize_lifecycle_matches(n):
    rng = np.random.default_rng(n)
    records = [{"latency_steps": int(rng.integers(5, 60)),
                "ttft_steps": int(rng.integers(0, 12)),
                "output_tokens": int(rng.integers(1, 20))}
               for _ in range(n)]
    kw = dict(slots=4, steps=200, requests=40)
    got = ttr.summarize_lifecycle(records, **kw)
    want = jtr.summarize_lifecycle(records, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))


@pytest.fixture(scope="module")
def stacks():
    jcfg, tcfg = configs("h2o_danube_1p8b")
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    return (jcfg, jm, jp), (tcfg, tm, params_from_numpy(to_np(jp), tcfg,
                                                         "cpu"))


@pytest.mark.parametrize("load", [0.1, 0.4])
def test_run_traffic_matches_reference(stacks, load):
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks
    kw = dict(num_requests=12, offered_load=load, vocab=jcfg.vocab_size)
    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**ECFG))
    je._decode = ref_jit(jm, "decode_step")
    je._prefill_chunk = ref_jit(jm, "prefill_chunk")
    want = jtr.run_traffic(je, jtr.TrafficConfig(**kw))
    te = tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(**ECFG),
                              device="cpu")
    got = ttr.run_traffic(te, ttr.TrafficConfig(**kw))
    assert got == want
    assert got["completed"] == 12
    assert te.lifecycle == je.lifecycle


SHAPES = [(1, 2560, 2560), (4, 2560, 640), (64, 6912, 2560),
          (256, 2560, 6912), (7, 100, 130)]
BLOCKS = [dict(block_m=128, block_n=128, block_k=128),
          dict(block_m=128, block_n=2048, block_k=128),
          dict(block_m=16, block_n=128, block_k=16),
          dict(block_m=64, block_n=64, block_k=16)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_traffic_model_matches_reference(shape):
    m, k, n = shape
    for blocks in BLOCKS:
        for fn in ("matmul_traffic_unfused", "mlp_traffic_unfused"):
            assert getattr(ttraffic, fn)(m, k, n, **blocks) == \
                getattr(jtraffic, fn)(m, k, n, **blocks)
        for fn in ("matmul_traffic_fused", "mlp_traffic_fused"):
            for coded in (True, False):
                got = getattr(ttraffic, fn)(m, k, n, weights_coded=coded,
                                            **blocks)
                assert got == getattr(jtraffic, fn)(
                    m, k, n, weights_coded=coded, **blocks)
                ttraffic.assert_no_roundtrip(got)
        with pytest.raises(AssertionError):
            ttraffic.assert_no_roundtrip(
                ttraffic.matmul_traffic_unfused(m, k, n, **blocks))
    for kvb in (1, 2, 4):
        assert ttraffic.decode_attention_traffic(m, k, 8, 4, 80,
                                                 kv_dtype_bytes=kvb) == \
            jtraffic.decode_attention_traffic(m, k, 8, 4, 80,
                                              kv_dtype_bytes=kvb)


def test_hopper_tiles():
    """``rows_per_block`` and ``Cfg::kBN`` / ``kBK`` of csrc/bp_mma.cuh."""
    tile = ttraffic.hopper_tiles
    assert [tile(m)["block_m"] for m in (1, 16, 17, 64, 65, 4096)] == \
        [16, 16, 64, 64, 128, 128]
    assert [tile(m, 2)["block_n"] for m in (4, 16, 17, 256)] == \
        [128, 128, 64, 64]
    assert {tile(m)["block_n"] for m in (1, 64, 256)} == {128}
    assert {tile(m, w)["block_k"] for m in (1, 256) for w in (1, 2)} == {16}


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = tmetrics.set_registry(reg)
    yield reg
    tmetrics.set_registry(prev)


def test_record_counts_eager_fused_calls(registry, rng):
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32))
    for _ in range(3):
        tops.oisma_matmul(x, w)
    tops.oisma_matmul(x, w.to(torch.bfloat16))
    codes, scale = tops.prepare_bp_weight(w)
    tops.oisma_matmul(x, codes, y_scale=scale)
    tops.oisma_matmul(x, w, impl="unfused")          # not a fused call
    with tmetrics.paused():                          # a graph's warm-up
        tops.oisma_matmul(x, w)
        tops.oisma_mlp(x, w, w)
    assert tmetrics.recording()
    tops.oisma_mlp(x, w, w)
    assert registry.value("kernels.calls", kernel="fused_matmul") == 5
    assert registry.value("kernels.calls", kernel="fused_mlp") == 1
    tiles = ttraffic.hopper_tiles(4)
    coded = ttraffic.matmul_traffic_fused(4, 64, 48, weights_coded=True,
                                          **tiles)
    unfused = ttraffic.matmul_traffic_unfused(4, 64, 48, **tiles)
    # the last fused matmul read codes: its gauge is the coded saving
    assert registry.value("kernels.bytes_saved", kernel="fused_matmul") == \
        unfused["total"] - coded["total"]
    mlp = ttraffic.mlp_traffic_fused(4, 64, 48, weights_coded=False,
                                     **ttraffic.hopper_tiles(4, 2))
    assert registry.value("kernels.bytes_saved", kernel="fused_mlp") == \
        ttraffic.mlp_traffic_unfused(4, 64, 48, **tiles)["total"] - \
        mlp["total"]
    assert registry.value("kernels.padded_elements",
                          kernel="fused_matmul") == 5 * coded[
        "padded_elements"]
