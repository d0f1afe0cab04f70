"""The Gemma family against the JAX reference, on the CPU: Gemma3's
local/global decoder (qk-norm, post-norms, scaled embeddings, a window
on five layers of six) and PaliGemma's prefix-LM (a bidirectional prefix
of patch embeddings).

Parameters come from the reference's ``init_tree`` and cross through
numpy (``params_from_numpy``); the reference is compiled with
``xla_allow_excess_precision`` off (``test_torch_model.py``), its Pallas
kernels in interpret mode under ``bp8_fused``.  At smoke size a greedy
stream of a random model often repeats one token, so the tests hold the
logits of every call as well as the tokens.

Tolerances: configs, windows, the scaled embedding and the converted
leaves exactly; ``gqa_apply`` outputs within one bf16 ulp (2**-8
relative) and its caches bitwise; logits at ``test_torch_model.py``'s
``MODES`` tolerances times its ``LOGIT_SCALE`` of 16 (the tied std-1
embedding makes these logits ~55, against ~3.4 for the other smoke
archs; observed <= 1.5e-5); bp8 caches bitwise; tokens equal.
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402

from test_torch_model import (  # noqa: E402
    EXACT, LOGIT_SCALE, MODES, configs, f32, jjit, prefill_batches, to_np)

GEMMA = ["gemma3_12b", "paligemma_3b"]
#: bf16, bp8 and bp8_fused with test_torch_model.py's tolerances
GEMMA_MODES = [m for m in MODES if m[0] in ("bf16", "bp8", "bp8_fused")]


def stacks(arch, mode="bp8_fused", kvq="bp8"):
    jcfg, tcfg = configs(arch, mode, kvq)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    return (jcfg, jm, jp), (tcfg, tm, params_from_numpy(to_np(jp), tcfg,
                                                         "cpu"))


# ---------------------------------------------------------------------------
# configs, windows, the converted leaves, the init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", GEMMA)
def test_config_matches_reference_field_for_field(arch, smoke):
    t, j = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", GEMMA)
def test_layer_windows_match_reference(arch, smoke):
    t, j = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    got, want = tmodel._layer_windows(t), jmodel._layer_windows(j)
    np.testing.assert_array_equal(got, want)
    if arch == "gemma3_12b":         # five local layers, then one global
        assert (got == tmodel.BIG_WINDOW).sum() == t.num_layers // 6
        assert list(got[:6]) == [t.window_size] * 5 + [tmodel.BIG_WINDOW]
    else:
        assert (got == tmodel.BIG_WINDOW).all()


@pytest.mark.parametrize("arch", GEMMA)
def test_params_from_numpy_carries_the_gemma_leaves(arch):
    """The schema-driven converter carries qk-norm and the post-norms with
    no change: the same leaf paths as the reference's tree, and values."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(arch)
    want = {tuple(k.key for k in path): np.asarray(
        a.astype(jnp.float32)) for path, a in
        jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(tree_leaves(tp))
    assert sorted(got) == sorted(want)
    extra = {("layers", "post_ln1"), ("layers", "post_ln2"),
             ("layers", "attn", "q_norm"), ("layers", "attn", "k_norm")}
    assert extra <= set(got) if arch == "gemma3_12b" else \
        not extra & set(got)
    for path, leaf in got.items():
        np.testing.assert_array_equal(f32(leaf), want[path],
                                      err_msg="/".join(path))


def test_init_scales_in_place_with_the_same_values():
    """``_init_leaf`` scales its f32 draw in place (one f32 copy of a leaf
    at a time): the values are those of ``randn * std``."""
    d = tparams.ParamDef((3, 40, 24), ("stack", "a", "b"))
    gen = torch.Generator().manual_seed(5)
    got = tparams._init_leaf(d, gen, torch.device("cpu"))
    want = (torch.randn(d.shape, generator=torch.Generator().manual_seed(5))
            * (1.0 / np.sqrt(40))).to(torch.bfloat16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# leaf functions: the scaled embedding, qk-norm and the prefix mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 2048, 3840])
def test_embed_lookup_scale_bitwise(d, rng):
    table = rng.normal(size=(50, d)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 7))
    want = f32(jjit(lambda t, i: jlayers.embed_lookup(t, i, scale=True))(
        jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(ids)))
    got = tlayers.embed_lookup(torch.from_numpy(table).bfloat16(),
                               torch.from_numpy(ids), scale=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), want)
    factor = {64: 8.0, 2048: 45.25, 3840: 62.0}[d]   # sqrt(d) in bf16
    np.testing.assert_array_equal(
        f32(got), f32(torch.from_numpy(table).bfloat16()[ids] * factor))


@pytest.mark.parametrize("prefix", [False, True], ids=["causal", "prefix"])
@pytest.mark.parametrize("kvq", ["none", "bp8"])
def test_gqa_apply_qk_norm_every_branch(kvq, prefix, rng):
    """gemma3's attention (qk-norm, window 16) with no cache, then a
    prefill, a chunk and decode steps past the window, in bp8_fused; with
    ``prefix`` a prefix length of 6 is passed to every call, so decode
    attends the dequantised cache (the fused kernel only without one)."""
    jcfg, tcfg = configs("gemma3_12b", "bp8_fused", kvq)
    jp = init_tree(jattn.gqa_defs(jcfg), jax.random.key(1))
    assert {"q_norm", "k_norm"} <= set(jp)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k[0] == "w" else
                                    torch.float32)
          for k, v in to_np(jp).items()}
    b, n, window, d = 2, 32, jcfg.window_size, jcfg.d_model
    jpre = jnp.full((b,), 6, jnp.int32) if prefix else None
    tpre = torch.full((b,), 6, dtype=torch.int32) if prefix else None

    def run(x, pos, cache, append=False):
        fn = jjit(lambda p, x, pos, c: jattn.gqa_apply(
            p, jcfg, x, pos, window=window, cache=c, prefix_len=jpre,
            append=append))
        jo, jc = fn(jp, jnp.asarray(x).astype(jnp.bfloat16),
                    jnp.asarray(pos), cache[0])
        to, _ = tattn.gqa_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(pos), window=window,
                                cache=cache[1], prefix_len=tpre,
                                append=append)
        np.testing.assert_allclose(f32(to), f32(jo), rtol=2 ** -8, atol=1e-6)
        if jc is not None:
            for k in jc:
                np.testing.assert_array_equal(f32(cache[1][k]), f32(jc[k]),
                                              err_msg=k)
        return jc

    x = rng.normal(size=(b, 20, d)).astype(np.float32)
    run(x, np.tile(np.arange(20, dtype=np.int32), (b, 1)), (None, None))
    jcache = jattn.init_cache(jattn.kv_cache_spec(jcfg, b, n))
    tcache = {k: torch.from_numpy(np.array(v.astype(jnp.float32)
                                           if v.dtype == jnp.bfloat16 else v)
                                  ).to(tattn.kv_cache_spec(tcfg, b, n)[k][1])
              for k, v in jcache.items()}
    jcache = run(x, np.tile(np.arange(20, dtype=np.int32), (b, 1)),
                 (jcache, tcache))                                # prefill
    x = rng.normal(size=(b, 4, d)).astype(np.float32)
    jcache = run(x, np.tile(np.arange(20, 24, dtype=np.int32), (b, 1)),
                 (jcache, tcache), append=True)                   # chunk
    for step in range(3):                                         # decode
        x = rng.normal(size=(b, 1, d)).astype(np.float32)
        jcache = run(x, np.array([[24 + step], [24 + step]], np.int32),
                     (jcache, tcache))


# ---------------------------------------------------------------------------
# the decoder's logits at every step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,kvq,tol", GEMMA_MODES,
                         ids=[m[0] for m in GEMMA_MODES])
@pytest.mark.parametrize("arch", GEMMA)
def test_decoder_logits_every_step(arch, mode, kvq, tol, rng):
    """gemma3: a 20-token prefill (past the window of 16), chunks of 8 and
    4, then 8 decode steps to position 39; paligemma: 8 patch embeddings
    and 12 tokens, then 8 decode steps.  The logits of every call, and
    the bp8 caches at the end."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(arch, mode, kvq)
    tol = tol * LOGIT_SCALE[arch]
    b = 2
    toks = rng.integers(2, jcfg.vocab_size, size=(b, 40))

    def check(tl, jl, what):
        np.testing.assert_allclose(tl.numpy(), np.array(jl), rtol=0,
                                   atol=tol, err_msg=what)

    s = 12 if jcfg.num_prefix_tokens else 20
    jb, tb = prefill_batches(jcfg, toks[:, :s], rng)
    jl, jc = jjit(jm.prefill, static_argnums=2)(jp, jb, 40)
    tl, tc = tm.prefill(tp, tb, 40)
    check(tl, jl, "prefill")
    pos = s + jcfg.num_prefix_tokens
    if not jcfg.num_prefix_tokens:
        for c in (8, 4):
            chunk = toks[:, pos:pos + c]
            jl, jc = jjit(jm.prefill_chunk)(jp, {"tokens": jnp.asarray(
                chunk)}, jc, jnp.int32(pos))
            tl, tc = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(
                chunk)}, tc, pos)
            check(tl, jl, f"chunk at {pos}")
            pos += c
    dec = jjit(jm.decode_step)
    for i in range(8):
        tok, p = toks[:, 30 + i:31 + i], np.full((b,), pos, np.int32)
        jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.asarray(p))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(p))
        check(tl, jl, f"decode at {pos}")
        pos += 1
    if kvq == "bp8":
        for k, v in jc["layers"].items():
            np.testing.assert_array_equal(tc["layers"][k].numpy(),
                                          np.array(v), err_msg=k)


# ---------------------------------------------------------------------------
# the engines: tokens, and the logits of every call
# ---------------------------------------------------------------------------

class _Recording:
    """A model whose ``prefill``, ``prefill_chunk`` and ``decode_step``
    record their logits (as f32 numpy) and return what the model does."""

    def __init__(self, model, calls):
        self._model, self.calls = model, calls

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _wrap(self, name, fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            self.calls.append((name, f32(logits)))
            return logits, cache
        return call

    def prefill(self, *a):
        return self._wrap("prefill", self._model.prefill)(*a)

    def prefill_chunk(self, *a):
        return self._wrap("prefill_chunk", self._model.prefill_chunk)(*a)

    def decode_step(self, *a):
        return self._wrap("decode_step", self._model.decode_step)(*a)


def _same_calls(got, want, tol):
    assert [n for n, _ in got] == [n for n, _ in want]
    for i, ((name, g), (_, w)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"call {i} ({name})")


def test_gemma3_paged_engine_matches_reference():
    """bp8_fused + bp8; slots 2, block 8, prefill chunk 8; prompts of 5,
    21 and 13 tokens (the second past the window of 16, the third
    admitted mid-stream), 8 new tokens each."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks("gemma3_12b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 21, 13)]
    kw = dict(slots=2, block_size=8, num_blocks=32, max_prefill_tokens=8)
    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**kw))
    je._decode = jax.jit(jm.decode_step, compiler_options=EXACT)
    je._prefill_chunk = jax.jit(jm.prefill_chunk, compiler_options=EXACT)
    je._decode = jrec._wrap("decode_step", je._decode)
    je._prefill_chunk = jrec._wrap("prefill_chunk", je._prefill_chunk)
    want = je.run([jpe.PagedRequest(rid=i, prompt=p, max_new_tokens=8)
                   for i, p in enumerate(prompts)])
    te = tpe.PagedServeEngine(_Recording(tm, tcalls), tp, tcfg,
                              tpe.PagedEngineConfig(**kw), device="cpu")
    got = te.run([tpe.PagedRequest(rid=i, prompt=p, max_new_tokens=8)
                  for i, p in enumerate(prompts)])
    assert got == want
    assert te.step_count == je.step_count
    _same_calls(tcalls, jcalls, 1e-5 * LOGIT_SCALE["gemma3_12b"])


def test_paligemma_lockstep_engine_matches_reference():
    """bp8_fused + bp8, 8 zero patch embeddings a request; slots 2,
    max_len 32: request 2 refills request 0's slot mid-stream, request
    3's prompt waits for the next generation."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks("paligemma_3b")
    specs = [([3, 4, 5], 2), ([6, 7, 8, 9, 10], 9), ([11, 12], 3),
             (list(range(20, 34)), 3)]

    def reqs(mod):
        return [mod.Request(rid=i, prompt=np.array(p, np.int32),
                            max_new_tokens=n)
                for i, (p, n) in enumerate(specs)]

    kw = dict(slots=2, max_len=32)
    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    je = jeng.ServeEngine(jm, jp, jcfg, jeng.EngineConfig(**kw))
    je._decode = jrec._wrap("decode_step", jax.jit(
        jm.decode_step, compiler_options=EXACT))
    je._prefill = jrec._wrap("prefill", jax.jit(
        jm.prefill, static_argnums=2, compiler_options=EXACT))
    want = je.run(reqs(jeng))
    te = teng.ServeEngine(_Recording(tm, tcalls), tp, tcfg,
                          teng.EngineConfig(**kw), device="cpu")
    got = te.run(reqs(teng))
    assert got == want
    assert [len(got[i]) for i in range(4)] == [2, 9, 3, 3]
    # the first generation's prefill, request 2's refill, the second's
    assert [n for n, _ in tcalls].count("prefill") == 3
    _same_calls(tcalls, jcalls, 1e-5 * LOGIT_SCALE["paligemma_3b"])
    # the decode graph's static cache holds the prefix too
    cache = te._decode.inputs((2, 32), None)[1]
    assert cache["layers"]["pos"].shape == (tcfg.num_layers, 2, 32 + 8)


def test_paged_engine_refuses_a_prefix_as_the_reference_does():
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks("paligemma_3b")
    with pytest.raises(AssertionError) as want:
        jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig())
    with pytest.raises(ValueError) as got:
        tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(),
                             device="cpu")
    assert str(got.value) == str(want.value)
