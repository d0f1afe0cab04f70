"""The port's lock-step engine, and both engines at temperature > 0, against
the JAX reference on the CPU.

* ``ServeEngine`` emits the reference's tokens, greedy and at T 0.8, on
  the smoke decoders in ``bp8_fused`` + ``bp8``, with a slot refilled
  mid-stream and a long prompt deferred to the next generation (as
  ``tests/test_serve.py``'s refill case);
* the port's versions of ``tests/test_serve_paged.py``'s
  ``test_paged_temperature_matches_contiguous`` (the paged engine at T 0.8
  gives each request's stream served alone on the lock-step engine) and
  ``test_paged_batch_composition_independence`` (slots 2 and 4 give the
  same sampled streams), in the reference's mode for them (bf16 matmuls,
  bf16 cache), each engine also held against the reference's tokens.  In
  ``bp8_fused`` the activation's BP scale is one per matmul call, so a
  stream depends on its batch (neighbours, padding rows, prefill chunks):
  there the engines part in the reference too, and the test holds each of
  the port's engines to the reference's.

The reference is compiled with ``xla_allow_excess_precision`` off (see
``test_torch_serve.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402

from test_torch_serve import EXACT, configs, to_np  # noqa: E402


def stacks(arch, mode="bp8_fused", kvq="bp8"):
    jcfg, tcfg = configs(arch, mode, kvq)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    return (jcfg, jm, jp), (tcfg, tm, params_from_numpy(to_np(jp), tcfg,
                                                         "cpu"))


def ref_lockstep(stack, **kw):
    cfg, model, params = stack
    eng = jeng.ServeEngine(model, params, cfg, jeng.EngineConfig(**kw))
    eng._decode = jax.jit(model.decode_step, compiler_options=EXACT)
    eng._prefill = jax.jit(model.prefill, static_argnums=2,
                           compiler_options=EXACT)
    return eng


def ref_paged(stack, **kw):
    cfg, model, params = stack
    eng = jpe.PagedServeEngine(model, params, cfg, jpe.PagedEngineConfig(
        **{**PAGED, **kw}))
    eng._decode = jax.jit(model.decode_step, compiler_options=EXACT)
    eng._prefill_chunk = jax.jit(model.prefill_chunk, compiler_options=EXACT)
    return eng


def port_paged(stack, **kw):
    cfg, model, params = stack
    return tpe.PagedServeEngine(model, params, cfg, tpe.PagedEngineConfig(
        **{**PAGED, **kw}), device="cpu")


PAGED = dict(slots=2, block_size=8, num_blocks=32, max_prefill_tokens=8)


def _prompts(seed, n, lo, hi, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1))
                         ).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module", params=["h2o_danube_1p8b", "qwen2_72b"])
def both(request):
    return stacks(request.param)


@pytest.fixture(scope="module")
def danube():
    return stacks("h2o_danube_1p8b")


@pytest.fixture(scope="module", params=[("bf16", "none"),
                                        ("bp8_fused", "bp8")],
                ids=["bf16", "bp8_fused"])
def danube_modes(request):
    return stacks("h2o_danube_1p8b", *request.param)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lockstep_engine_matches_reference(both, temperature):
    """slots 2: request 2 refills request 0's slot mid-stream; request 3's
    20-token prompt is longer than the cache position, so it and request 4
    behind it wait for the next generation."""
    jstack, tstack = both
    specs = [([3, 4, 5], 2), ([6, 7, 8], 12), ([9, 10, 11], 2),
             (list(range(20, 40)), 3), ([12, 13, 14, 15], 2)]

    def reqs(mod):
        return [mod.Request(rid=i, prompt=np.array(p, np.int32),
                            max_new_tokens=n)
                for i, (p, n) in enumerate(specs)]

    kw = dict(slots=2, max_len=64, temperature=temperature)
    want = ref_lockstep(jstack, **kw).run(reqs(jeng), seed=5)
    cfg, model, params = tstack
    port = teng.ServeEngine(model, params, cfg, teng.EngineConfig(**kw),
                            device="cpu")
    calls = {"n": 0}
    orig = port._decode.fn

    def counting(*a):
        calls["n"] += 1
        return orig(*a)

    port._decode.fn = counting
    got = port.run(reqs(teng), seed=5)
    assert got == want
    assert [len(got[i]) for i in range(5)] == [2, 12, 2, 3, 2]
    # one generation of 12 ticks for requests 0-2, then one for 3 and 4:
    # the refill cost no tick, the deferral one generation
    assert calls["n"] == 11 + 2
    assert port.compile_counts() == {"decode_step": 1}   # (2, 64) only


def test_lockstep_engine_refuses_cpu_capture_and_long_prompts(danube):
    _, (cfg, model, params) = danube
    with pytest.raises(ValueError, match="capture=True needs"):
        teng.ServeEngine(model, params, cfg, teng.EngineConfig(),
                         device="cpu", capture=True)
    eng = teng.ServeEngine(model, params, cfg,
                           teng.EngineConfig(slots=1, max_len=16),
                           device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        eng.run([teng.Request(rid=0, prompt=np.arange(16, dtype=np.int32)
                              + 3, max_new_tokens=2)])


def _served_alone(mod, engine_of, prompts, max_new, temperature, seed):
    out = {}
    for i, p in enumerate(prompts):
        eng = engine_of(dict(slots=1, max_len=64, temperature=temperature))
        out.update(eng.run([mod.Request(rid=i, prompt=p,
                                        max_new_tokens=max_new)], seed=seed))
    return out


def test_paged_temperature_matches_contiguous(danube_modes):
    """Counter-based sampling keyed on (seed, rid, step): in bf16 the
    sampled stream survives the engine swap bit for bit, in the port as in
    the reference; in both modes each of the port's engines gives the
    reference's streams."""
    jstack, tstack = danube_modes
    cfg, model, params = tstack
    prompts = _prompts(3, 4, 3, 14, cfg.vocab_size)
    alone = _served_alone(
        teng, lambda kw: teng.ServeEngine(model, params, cfg,
                                          teng.EngineConfig(**kw),
                                          device="cpu"),
        prompts, 6, 0.8, 7)
    got = port_paged(tstack, slots=3, temperature=0.8).run(
        [tpe.PagedRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)], seed=7)
    want = ref_paged(jstack, slots=3, temperature=0.8).run(
        [jpe.PagedRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)], seed=7)
    assert got == want
    ref_alone = _served_alone(jeng, lambda kw: ref_lockstep(jstack, **kw),
                              prompts, 6, 0.8, 7)
    assert alone == ref_alone
    if cfg.matmul_mode == "bf16":
        assert got == alone
    else:                   # the batch-dependent scale parts the engines
        assert got != alone and want != ref_alone


def test_paged_batch_composition_independence(danube_modes):
    """In bf16 a request's sampled stream does not depend on which
    neighbours share its decode batch (slots 2 and 4, T 0.8); in both
    modes the streams are the reference's."""
    jstack, tstack = danube_modes
    prompts = _prompts(4, 5, 3, 14, tstack[0].vocab_size)

    def reqs(mod):
        return [mod.PagedRequest(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]

    narrow = port_paged(tstack, slots=2, temperature=0.8).run(reqs(tpe),
                                                               seed=11)
    wide_engine = port_paged(tstack, slots=4, temperature=0.8)
    wide = wide_engine.run(reqs(tpe), seed=11)
    assert wide_engine.ecfg.seed == 11
    assert wide == ref_paged(jstack, slots=4, temperature=0.8).run(
        reqs(jpe), seed=11)
    if tstack[0].matmul_mode == "bf16":
        assert narrow == wide
    else:
        assert narrow == ref_paged(jstack, slots=2, temperature=0.8).run(
            reqs(jpe), seed=11)
