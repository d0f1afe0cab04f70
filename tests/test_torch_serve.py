"""The port's serving stack against the JAX reference, on the CPU.

* scheduler: the same submissions and admission offers give the same
  admissions, in the same order;
* paged cache: the same allocations, commits and frees give the same
  block tables, gathered views and (scrubbed) pools;
* the slice as a whole: the port's ``PagedServeEngine`` emits the same
  greedy tokens, in the same engine steps, as the reference's, on the
  smoke decoders in ``bp8_fused`` + ``bp8`` with mid-stream admission.
  The reference is compiled with ``xla_allow_excess_precision`` off (see
  ``test_torch_model.py``: with it on, XLA keeps some bf16 sums in f32
  and the streams part after a few tokens).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}


def configs(arch, mode="bp8_fused", kvq="bp8"):
    return (dataclasses.replace(jget_config(arch, smoke=True),
                                matmul_mode=mode, kv_quant=kvq),
            dataclasses.replace(get_config(arch, smoke=True),
                                matmul_mode=mode, kv_quant=kvq))


def to_np(tree):
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Req:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    priority: int


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_reference(seed):
    rng = np.random.default_rng(seed)
    js, ts = jsched.PriorityScheduler(20, 8), tsched.PriorityScheduler(20, 8)
    rid = 0
    for _ in range(60):
        if rng.random() < 0.6:
            plen, new, prio = (int(rng.integers(1, 120)),
                               int(rng.integers(1, 40)),
                               int(rng.integers(0, 3)))
            a = js.submit(_Req(rid, np.zeros(plen), new, prio))
            b = ts.submit(_Req(rid, np.zeros(plen), new, prio))
            assert a == b
            rid += 1
        else:
            slots, blocks = int(rng.integers(0, 4)), int(rng.integers(0, 21))
            assert ([r.rid for r in js.admit(slots, blocks)]
                    == [r.rid for r in ts.admit(slots, blocks)])
        assert js.pending == ts.pending
        assert ([r.rid for r in js.pending_requests()]
                == [r.rid for r in ts.pending_requests()])
    for plen in range(0, 40, 3):
        for new in (1, 8, 17):
            assert (tsched.blocks_needed(plen, new, 8)
                    == jsched.blocks_needed(plen, new, 8))


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

def _assert_tree_equal(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = [t for _, t in tpc.tree_leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.array(a))


def test_paged_cache_matches_reference(rng):
    jcfg, tcfg = configs("h2o_danube_1p8b")
    jc = jpc.PagedCache(jbuild(jcfg), jcfg, slots=2, num_blocks=9,
                        block_size=4)
    tc = tpc.PagedCache(build(tcfg), slots=2, num_blocks=9, block_size=4,
                        device="cpu")

    def pools_equal():
        assert jc.tables == tc.tables
        assert jc.free_blocks == tc.free_blocks
        for a, b in zip(jc._pool, tc.pool):
            np.testing.assert_array_equal(b.numpy(), np.array(a))

    for slot, n in ((0, 3), (1, 2)):
        jc.alloc_slot(slot, n)
        tc.alloc_slot(slot, n)
    pools_equal()
    assert [tc.view_len(t) for t in range(1, 40)] == \
        [jc.view_len(t) for t in range(1, 40)]

    def random_view(view):
        """Fill a gathered view with the same random cells on both sides."""
        out = {}
        for path, leaf in tpc.tree_leaves(view):
            if leaf.dtype == torch.int8:
                v = rng.integers(-9, 10, size=leaf.shape).astype(np.int8)
            elif leaf.dtype == torch.int32:
                v = rng.integers(0, 64, size=leaf.shape).astype(np.int32)
            else:
                v = rng.random(size=leaf.shape).astype(np.float32)
            out[path[-1]] = v
        return ({"layers": {k: jnp.asarray(v) for k, v in out.items()}},
                {"layers": {k: torch.from_numpy(v) for k, v in out.items()}})

    jv, tv = random_view(tc.gather([0], tc.view_len(10)))
    jc.commit_prefill(jv, 0, 2, 8)
    tc.commit_prefill(tv, 0, 2, 8)
    pools_equal()
    jv, tv = random_view(tc.gather([0, 1, 0], 16))
    jc.commit_decode(jv, [0, 1], [0, 1], [10, 5])
    tc.commit_decode(tv, [0, 1], [0, 1], [10, 5])
    pools_equal()
    _assert_tree_equal(jc.gather([1, 0, 0], 16), tc.gather([1, 0, 0], 16))
    jc.free_slot(0)
    tc.free_slot(0)
    pools_equal()                       # freed blocks scrubbed to pos -1
    jc.alloc_slot(0, 4)
    tc.alloc_slot(0, 4)
    pools_equal()
    _assert_tree_equal(jc.gather([0, 1], 16), tc.gather([0, 1], 16))


# ---------------------------------------------------------------------------
# the slice as a whole: the paged engine's greedy tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b"])
def test_paged_engine_tokens_match_reference(arch):
    """Slots 2, block 8, 32 blocks, prefill chunk 8, prompts of 5/13/9
    tokens (the third is admitted mid-stream), 8 new tokens each."""
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
    got = te.run([tpe.PagedRequest(rid=i, prompt=p, max_new_tokens=8)
                  for i, p in enumerate(prompts)])
    assert got == want
    assert te.step_count == je.step_count
    assert te.lifecycle == je.lifecycle
    ts, js = te.stats.snapshot(), je.stats.snapshot()
    for key in ("steps", "prefill_chunks", "decode_ticks", "admitted",
                "deferred_steps", "prefill_shapes", "decode_shapes"):
        assert ts[key] == js[key], key


def test_temperature_sampling_waits_for_its_slice():
    """The sampling slice has landed: an engine at temperature > 0 is
    built, serves, and its streams are a function of the seed (bit for bit
    the reference's: ``test_torch_engine.py``)."""
    _, tcfg = configs("h2o_danube_1p8b")
    tm = build(tcfg)
    from repro_torch.models.params import init_params
    params = init_params(tm.schema(), 0, "cpu")

    def run(seed):
        te = tpe.PagedServeEngine(tm, params, tcfg,
                                  tpe.PagedEngineConfig(temperature=0.7),
                                  device="cpu")
        return te.run([tpe.PagedRequest(rid=i, prompt=np.arange(
            3, 8 + i, dtype=np.int32), max_new_tokens=6) for i in range(3)],
            seed=seed)

    first = run(13)
    assert first == run(13)
    assert first != run(14)


def test_unservable_request_is_rejected():
    _, tcfg = configs("h2o_danube_1p8b")
    tm = build(tcfg)
    from repro_torch.models.params import init_params
    te = tpe.PagedServeEngine(tm, init_params(tm.schema(), 0, "cpu"), tcfg,
                              tpe.PagedEngineConfig(num_blocks=3,
                                                    block_size=8),
                              device="cpu")
    with pytest.raises(ValueError, match="exceeds the cache pool"):
        te.submit(tpe.PagedRequest(rid=0, prompt=np.zeros(20, np.int32),
                                   max_new_tokens=4))
    assert te.stats.rejected == 1
