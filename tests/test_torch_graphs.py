"""The paged engine's compiled entry points, ported, on the CPU.

The reference runs ``decode_step`` and ``prefill_chunk`` under
``jax.jit`` and bounds how many shapes it compiles
(``compile_shape_bounds``).  The port runs them as CUDA graphs over
static buffers (``serve/graphs.py``); on the CPU nothing is captured and
the same static buffers are filled and read, so these tests cover:

* ``compile_shape_bounds`` equals the reference's for several engine
  configurations;
* prompts of every length 1-30 (the reference's
  ``test_paged_retrace_bound``) stay within the bound, in shapes and in
  static entries per entry point;
* ``prefill_chunk`` with ``pos0`` as a device tensor gives bitwise the
  logits and cache of ``pos0`` as an int;
* the gather into a static view writes every cell of it;
* the engine over its static buffers emits the reference's tokens, step
  count and lifecycle on both smoke archs, and again on a second run
  over the same buffers.

The card's side (graphs replayed bitwise equal to eager, captured tokens
equal to eager ones) is in ``tests/test_torch_cuda.py`` (marked ``gpu``)
and ``chip_smoke.py`` phases 3 and 4.
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402
from repro_torch.serve.graphs import GraphedEntry  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}


def configs(arch):
    return (dataclasses.replace(jget_config(arch, smoke=True),
                                matmul_mode="bp8_fused", kv_quant="bp8"),
            dataclasses.replace(get_config(arch, smoke=True),
                                matmul_mode="bp8_fused", kv_quant="bp8"))


def to_np(tree):
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


def _trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        pa == pb and torch.equal(x, y) for (pa, x), (pb, y) in zip(la, lb))


@pytest.fixture(scope="module")
def danube():
    _, tcfg = configs("h2o_danube_1p8b")
    model = build(tcfg)
    return tcfg, model, init_params(model.schema(), 0, "cpu")


# ---------------------------------------------------------------------------
# the compile bound
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    dict(slots=2, block_size=8, num_blocks=32, max_prefill_tokens=8),
    dict(slots=4, block_size=16, num_blocks=96, max_prefill_tokens=64),
    dict(slots=1, block_size=4, num_blocks=2, max_prefill_tokens=1),
    dict(slots=3, block_size=16, num_blocks=33, max_prefill_tokens=32),
    dict(slots=2, block_size=8, num_blocks=257, max_prefill_tokens=128),
], ids=["default", "test_serve", "chip_smoke", "least", "odd_pool",
        "wide_pool"])
def test_compile_shape_bounds_match_reference(kw, danube):
    tcfg, model, params = danube
    jcfg, _ = configs("h2o_danube_1p8b")
    je = jpe.PagedServeEngine(jbuild(jcfg), None, jcfg,
                              jpe.PagedEngineConfig(**kw))
    te = tpe.PagedServeEngine(model, params, tcfg,
                              tpe.PagedEngineConfig(**kw), device="cpu")
    assert te.compile_shape_bounds() == je.compile_shape_bounds()
    assert te.compile_counts() == {"prefill_chunk": 0, "decode_step": 0}


def test_paged_retrace_bound(danube):
    """Every prompt length 1..30 (the reference's test): the shapes, and
    the static entries per entry point, stay within the bound."""
    tcfg, model, params = danube
    eng = tpe.PagedServeEngine(
        model, params, tcfg, tpe.PagedEngineConfig(
            slots=2, num_blocks=64, max_prefill_tokens=8), device="cpu")
    rng = np.random.default_rng(5)
    lengths = list(range(1, 31))
    eng.run([tpe.PagedRequest(rid=i, prompt=rng.integers(
        2, tcfg.vocab_size, size=n).astype(np.int32), max_new_tokens=2)
        for i, n in enumerate(lengths)])
    chunk_kinds, view_kinds = 4, 4          # 1, 2, 4, 8; 8..64 tokens
    assert len(eng.stats.prefill_shapes) <= chunk_kinds * view_kinds
    assert len(eng.stats.decode_shapes) <= view_kinds
    counts = eng.compile_counts()
    assert counts == {"prefill_chunk": len(eng.stats.prefill_shapes),
                      "decode_step": len(eng.stats.decode_shapes)}
    bounds = eng.compile_shape_bounds()     # the analytic ceiling
    assert all(counts[k] <= bounds[k] for k in bounds)
    assert len(eng.stats.prefill_shapes) < len(set(lengths))
    assert eng.stats.snapshot()["capture_s"] == 0.0


def test_capture_needs_cuda(danube):
    tcfg, model, params = danube
    with pytest.raises(ValueError, match="CUDA"):
        tpe.PagedServeEngine(model, params, tcfg, tpe.PagedEngineConfig(),
                             device="cpu", capture=True)


def test_uncaptured_entry_calls_fn_on_its_static_inputs():
    seen = []
    entry = GraphedEntry(lambda a, b: seen.append((a, b)) or a + b,
                         capture=False)
    a, b = entry.inputs("k", lambda: (torch.zeros(3), torch.ones(3)))
    assert entry.inputs("k", lambda: pytest.fail("made twice")) == (a, b)
    a.fill_(2.0)
    assert torch.equal(entry("k"), torch.full((3,), 3.0))
    assert seen[0][0] is a and seen[0][1] is b
    entry.inputs("j", lambda: (torch.zeros(1), torch.zeros(1)))
    assert entry.count == 2 and entry.capture_s == 0.0


def test_capture_runs_with_the_cyclic_collector_off(monkeypatch):
    """A dead cycle holding another graph must not be collected while a
    stream captures (destroying a graph then invalidates the capture): the
    collector is off inside the capture, on again after it, also when the
    capture raises."""
    import gc
    seen = []

    class FakeGraph:
        def replay(self):
            seen.append(("replay", gc.isenabled()))

    class FakeCapture:
        def __init__(self, graph, pool=None):
            pass

        def __enter__(self):
            seen.append(("capture", gc.isenabled()))

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    entry = GraphedEntry(lambda x: x + 1, capture=True)
    entry.inputs("k", lambda: (torch.zeros(2),))
    assert torch.equal(entry("k"), torch.ones(2))
    assert seen == [("capture", False), ("replay", True)]
    assert gc.isenabled()
    failing = GraphedEntry(lambda x: 1 / 0 if not gc.isenabled() else x,
                           capture=True)
    failing.inputs("k", lambda: (torch.zeros(2),))
    with pytest.raises(ZeroDivisionError):
        failing("k")
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# pos0 as a tensor; the gather into static views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b"])
def test_prefill_chunk_tensor_pos0_bitwise(arch):
    _, tcfg = configs(arch)
    model = build(tcfg)
    params = init_params(model.schema(), 1, "cpu")
    rng = np.random.default_rng(3)
    caches = {form: model.init_cache(1, 32, "cpu")
              for form in ("int", "0-dim", "1-elem")}
    for pos0 in (0, 8, 16):
        tokens = torch.from_numpy(rng.integers(2, tcfg.vocab_size, (1, 8)))
        out = {}
        for form, cache in caches.items():
            p = {"int": pos0, "0-dim": torch.tensor(pos0),
                 "1-elem": torch.tensor([pos0], dtype=torch.int32)}[form]
            out[form], caches[form] = model.prefill_chunk(
                params, {"tokens": tokens}, cache, p)
        for form in ("0-dim", "1-elem"):
            assert torch.equal(out[form], out["int"])
            assert _trees_equal(caches[form], caches["int"])


def test_gather_into_static_view_writes_every_cell(danube):
    tcfg, model, _ = danube
    pc = tpc.PagedCache(model, slots=3, num_blocks=12, block_size=4,
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in pc.pool:                 # random pool contents
        if leaf.dtype.is_floating_point:
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
        else:
            leaf.copy_(torch.randint(-9, 10, leaf.shape, generator=gen))
    pc.alloc_slot(0, 3)
    pc.alloc_slot(2, 5)
    for slots, view_tokens in (([2, 0, 0], 16), ([0], 8), ([2, 2, 1], 32)):
        out = pc.empty_view(len(slots), view_tokens)
        for _, leaf in tree_leaves(out):  # stale cells from an earlier step
            leaf.fill_(7)
        got = pc.gather(slots, view_tokens, out=out)
        assert got is out
        assert _trees_equal(out, pc.gather(slots, view_tokens))
    with pytest.raises(ValueError, match="want"):
        pc.gather([0, 2], 16, out=pc.empty_view(2, 8))


# ---------------------------------------------------------------------------
# the engine over its static buffers against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b"])
def test_engine_static_buffers_match_reference(arch):
    """Slots 2, block 8, 32 blocks, prefill chunk 8, prompts of 5/13/9
    tokens, 8 new tokens each: the reference's tokens, steps and
    lifecycle; then the same requests again on the same engine, through
    the buffers the first run left behind."""
    jcfg, tcfg = configs(arch)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 9)]
    kw = dict(slots=2, block_size=8, num_blocks=32, max_prefill_tokens=8)

    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**kw))
    je._decode = jax.jit(jm.decode_step, compiler_options=EXACT)
    je._prefill_chunk = jax.jit(jm.prefill_chunk, compiler_options=EXACT)
    want = je.run([jpe.PagedRequest(rid=i, prompt=p, max_new_tokens=8)
                   for i, p in enumerate(prompts)])

    te = tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(**kw),
                              device="cpu")
    assert not te.capture
    got = te.run([tpe.PagedRequest(rid=i, prompt=p, max_new_tokens=8)
                  for i, p in enumerate(prompts)])
    assert got == want
    assert te.step_count == je.step_count
    assert te.lifecycle == je.lifecycle
    counts = te.compile_counts()
    bounds = te.compile_shape_bounds()
    assert all(0 < counts[k] <= bounds[k] for k in bounds)
    again = te.run([tpe.PagedRequest(rid=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)])
    assert again == want
    assert te.step_count == 2 * je.step_count
    assert te.compile_counts() == counts
