"""The port's decoder against the JAX reference, on the CPU.

Parameters come from the reference's ``init_tree`` and cross through
numpy (``params_from_numpy``).  The reference is compiled with XLA's
``xla_allow_excess_precision`` off: with it on (XLA's default), jitted
CPU code keeps the f32 result of some bf16 additions (the residual and
bias adds) instead of rounding it where the code casts, which moves the
smoke model's logits by up to ~0.5 in bp8_fused mode (a bf16 flip can
move a value across a BP level boundary).  The port rounds where the
code casts, as the reference does with the flag off.

Tolerances:
  * ``rms_norm`` — bf16 output equal to 1 bf16 ulp (observed exact);
    f32 output within 4 ulp (the mean over d_model reduces in another
    order);
  * ``apply_rope`` — f32 within 1e-5 absolute: XLA constant-folds the
    frequencies, which can differ from a runtime pow by one ulp, and the
    angle error grows with the position (observed <= 1.1e-5 at
    positions 100-112; the test uses positions < 64);
  * ``quantize_kv``/``dequantize_kv`` — bitwise;
  * bp8 caches written by ``gqa_apply`` and the decoder — bitwise;
  * logits in ``bp8_fused`` + ``bp8`` — 1e-5 absolute (observed <= 5e-7:
    the BP codes and caches agree bit for bit, and what is left is f32
    reassociation in the softmax and the logits matmul);
  * logits in ``bf16`` — 2e-2 absolute on logits of magnitude ~3: the
    bf16 matmuls accumulate in another order, so a product can round to
    the neighbouring bf16 value, and the residual stream carries it;
  * ``dense`` and logits in ``bp8`` (+ ``bp8`` cache) — ``dense`` bitwise
    and logits 1e-5, as in ``bp8_fused``: the bitplane products are exact
    integers; greedy tokens equal over 16 decode steps;
  * ``dense`` in ``bp8_lowrank`` and ``fp8`` — one bf16 ulp (2**-8
    relative): their f32 sums (non-integer low-rank factors, E4M3 values)
    round in another order before the cast to bf16;
  * logits in ``fp8`` — 1e-5 (observed 0: on these inputs no sum rounds
    differently);
  * the Gemma family (gemma3, paligemma) ties its std-1 embedding to
    the logits, which reach ~55 on their smoke configs against ~3.4 for
    the other two archs: its absolute logit tolerances are the table's
    times 16 (``LOGIT_SCALE``), the same precision relative to the
    logits (observed <= 1.5e-5 in ``bp8_fused``, a few f32 ulps of 55);
  * logits in ``bp8_lowrank`` — 1.0 absolute on logits of magnitude
    ~3.4.  A one-ulp difference of a low-rank f32 sum can flip a bf16
    projection output; the next layer's BP re-quantisation turns that flip
    into a level (or scale) change, which moves the logits by up to 0.91
    (observed, both anchors).  ``dense`` above bounds the mode per call;
    the same amplification separates the reference's own jitted runs with
    and without excess precision by up to 1.62;
  * the MoE and MLA archs (granite-moe, deepseek-v2, minicpm3) run in
    ``bp8_fused``, ``bf16`` and ``bp8``.  granite-moe and minicpm3 tie
    std-1 embeddings, logits of ~62 and ~31: ``LOGIT_SCALE`` 16 and 8
    (observed <= 7.6e-6 and 3.8e-6 in ``bp8_fused``, 0.089 for minicpm3
    in ``bf16``).  deepseek-v2 in ``bf16`` — 5e-2 (observed 0.03 on
    logits of ~3.9): its routed experts are plain bf16 matmuls, as the
    reference's, which torch and XLA accumulate in other orders, over
    three layers;
  * MLA (deepseek-v2, minicpm3) keeps a bf16 latent cache in every mode:
    the reference refuses a ``bp8`` one, so the bp8 rows run it with
    ``kv_quant="none"``; in ``bp8_fused`` and ``bp8`` the latent caches
    are bitwise the reference's.
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import attention as jkattn  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import attention as tkattn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
ARCHS = ["h2o_danube_1p8b", "qwen2_72b", "gemma3_12b", "paligemma_3b",
         "granite_moe_1b", "deepseek_v2_236b", "minicpm3_4b"]
#: MLA archs: their latent cache is bf16 (the reference refuses a bp8 one)
MLA = ("deepseek_v2_236b", "minicpm3_4b")
MOE_MLA = ("granite_moe_1b",) + MLA
#: absolute logit tolerances scale with the logits' magnitude (docstring)
LOGIT_SCALE = {"gemma3_12b": 16.0, "paligemma_3b": 16.0,
               "granite_moe_1b": 16.0, "minicpm3_4b": 8.0}
#: (arch, mode) tolerances other than ``MODES``' (docstring)
TOL = {("deepseek_v2_236b", "bf16"): 5e-2}
MODES = [("bp8_fused", "bp8", 1e-5), ("bf16", "none", 2e-2),
         ("bp8", "bp8", 1e-5), ("bp8_lowrank", "none", 1.0),
         ("fp8", "none", 1e-5)]
#: the logits cases: every mode on the dense GQA archs; bp8_fused, bf16
#: and bp8 on the MoE/MLA ones
LOGIT_CASES = [pytest.param(a, *m, id=f"{a}-{m[0]}") for a in ARCHS
               for m in MODES if a not in MOE_MLA
               or m[0] in ("bp8_fused", "bf16", "bp8")]


def jjit(fn, **kw):
    """The reference, compiled to round where its code casts."""
    return jax.jit(fn, compiler_options=EXACT, **kw)


_JITTED = {}


def ref_jit(model, name, **kw):
    """``jjit`` of the reference model's entry point ``name``, made once
    per model object: a new jit object compiles every shape again.  The
    memo keeps the model alive, so its ``id`` is never reused."""
    key = (id(model), name, tuple(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = (model, jjit(getattr(model, name), **kw))
    return _JITTED[key][1]


def to_np(tree):
    """Reference arrays -> numpy; bf16 leaves as (exact) float32."""
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def configs(arch, mode, kvq):
    if arch in MLA:
        kvq = "none"
    return (dataclasses.replace(jget_config(arch, smoke=True),
                                matmul_mode=mode, kv_quant=kvq),
            dataclasses.replace(get_config(arch, smoke=True),
                                matmul_mode=mode, kv_quant=kvq))


def prefill_batches(cfg, tokens, rng):
    """The reference's and the port's prefill batch of ``tokens``, with
    seeded bf16 patch embeddings ahead of them where the config has a
    prefix (paligemma)."""
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(np.asarray(tokens, np.int64))}
    if cfg.num_prefix_tokens:
        pt = rng.normal(size=(tokens.shape[0], cfg.num_prefix_tokens,
                              cfg.d_model)).astype(np.float32)
        jb["patches"] = jnp.asarray(pt).astype(jnp.bfloat16)
        tb["patches"] = torch.from_numpy(pt).bfloat16()
    return jb, tb


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 2560])
def test_rms_norm_matches_reference(d, rng):
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    g = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    fn = jjit(jlayers.rms_norm)
    want = np.array(fn(jnp.asarray(x), jnp.asarray(g)))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    want = f32(fn(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g)))
    got = f32(tlayers.rms_norm(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(g)))
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta, rng):
    x = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(64), np.arange(64)[::-1]]).astype(np.int32)
    want = np.array(jjit(lambda x, p: jlayers.apply_rope(x, p, theta))(
        jnp.asarray(x), jnp.asarray(pos)))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tlayers.rope_frequencies(16, theta).numpy(),
        np.array(jlayers.rope_frequencies(16, theta)))


def test_quantize_and_dequantize_kv_bitwise(rng):
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # all-zero head: tiny
    jc, js = jkattn.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16))
    tc, ts = tkattn.quantize_kv(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(tc.numpy(), np.array(jc))
    np.testing.assert_array_equal(ts.numpy(), np.array(js))
    np.testing.assert_array_equal(
        tkattn.dequantize_kv(tc, ts).numpy(),
        np.array(jkattn.dequantize_kv(jc, js)))


# ---------------------------------------------------------------------------
# gqa_apply over a bp8 cache: prefill, append (chunked prefill), decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MLA])
def test_gqa_apply_bp8_cache_branches(arch, rng):
    jcfg, tcfg = configs(arch, "bp8_fused", "bp8")
    jp = init_tree(jattn.gqa_defs(jcfg), jax.random.key(1))
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k[0] in "wb" else
                                    torch.float32)
          for k, v in to_np(jp).items()}
    b, n, window = 2, 32, jcfg.window_size
    jcache = jattn.init_cache(jattn.kv_cache_spec(jcfg, b, n))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}

    def run(x, pos, append):
        nonlocal jcache
        fn = jjit(lambda p, x, pos, c: jattn.gqa_apply(
            p, jcfg, x, pos, window=window, cache=c, append=append))
        jo, jcache = fn(jp, jnp.asarray(x).astype(jnp.bfloat16),
                        jnp.asarray(pos), jcache)
        to, _ = tattn.gqa_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(pos), window=window,
                                cache=tcache, append=append)
        np.testing.assert_allclose(f32(to), f32(jo), rtol=2 ** -8, atol=1e-6)
        for k in jcache:
            np.testing.assert_array_equal(tcache[k].numpy(),
                                          np.array(jcache[k]), err_msg=k)

    d = jcfg.d_model
    x = rng.normal(size=(b, 12, d)).astype(np.float32)
    run(x, np.tile(np.arange(12, dtype=np.int32), (b, 1)), False)  # prefill
    x = rng.normal(size=(b, 4, d)).astype(np.float32)
    run(x, np.tile(np.arange(12, 16, dtype=np.int32), (b, 1)), True)  # append
    for step in range(3):                                          # decode
        x = rng.normal(size=(b, 1, d)).astype(np.float32)
        run(x, np.array([[16 + step], [16 + step]], np.int32), False)


# ---------------------------------------------------------------------------
# DecoderModel: prefill, prefill_chunk, decode_step logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode,kvq,tol", LOGIT_CASES)
def test_decoder_logits_match_reference(arch, mode, kvq, tol, rng):
    jcfg, tcfg = configs(arch, mode, kvq)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    tol = TOL.get((arch, mode), tol) * LOGIT_SCALE.get(arch, 1.0)
    b, s, cache_len = 2, 12, 32
    toks = rng.integers(2, jcfg.vocab_size, size=(b, s + 4 + 3))

    def tt(a):
        return torch.from_numpy(np.asarray(a, np.int64))

    jb, tb = prefill_batches(jcfg, toks[:, :s], rng)
    jl, jc = jjit(jm.prefill, static_argnums=2)(jp, jb, cache_len)
    tl, tc = tm.prefill(tp, tb, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.array(jl), rtol=0, atol=tol)

    p = s + jcfg.num_prefix_tokens         # next position (prefix counted)
    if jcfg.num_prefix_tokens:             # the chunked prefill refuses it
        with pytest.raises(ValueError, match="no prefix tokens"):
            tm.prefill_chunk(tp, {"tokens": tt(toks[:, s:s + 4])}, tc, p)
    else:
        jl, jc = jjit(jm.prefill_chunk)(jp, {"tokens": jnp.asarray(
            toks[:, s:s + 4])}, jc, jnp.int32(s))
        tl, tc = tm.prefill_chunk(tp, {"tokens": tt(toks[:, s:s + 4])}, tc,
                                  s)
        np.testing.assert_allclose(tl.numpy(), np.array(jl), rtol=0,
                                   atol=tol)
        p += 4

    dec = jjit(jm.decode_step)
    for i in range(3):
        pos = np.full((b,), p + i, np.int32)
        tok = toks[:, s + 4 + i:s + 5 + i]
        jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tt(tok), tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.array(jl), rtol=0,
                                   atol=tol)
    if kvq == "bp8":       # the caches (MLA's bf16 latents too) bitwise
        for name in jc:
            for k, v in jc[name].items():
                np.testing.assert_array_equal(f32(tc[name][k]), f32(v),
                                              err_msg=f"{name}/{k}")


def test_params_from_numpy_layout_and_dtypes():
    jcfg, tcfg = configs("qwen2_72b", "bp8_fused", "bp8")
    jp = init_tree(jbuild(jcfg).schema(), jax.random.key(0))
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    assert tp["layers"]["attn"]["wq"].shape == (2, 64, 64)
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["bk"].shape == (2, 16)
    assert tp["layers"]["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["head"].float().numpy(), np.array(jp["head"].astype(jnp.float32)))
    bad = to_np(jp)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, tcfg, "cpu")


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("mode,rtol", [("bp8", 0.0), ("bp8_lowrank", 2 ** -8),
                                       ("fp8", 2 ** -8)])
def test_dense_modes_match_reference(mode, rtol, dtype, rng):
    """bf16 with a bias, as the model calls it; f32 without one (in f32
    the compiled reference contracts ``c * scale + bias`` into an FMA,
    which no eager program reproduces)."""
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f32": (torch.float32, jnp.float32)}[dtype]
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.125).astype(np.float32)
    b = (rng.normal(size=(48,)) * 0.1).astype(np.float32) \
        if dtype == "bf16" else None
    want = f32(jjit(lambda x, w, b: jlayers.dense(x, w, mode, b))(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
        None if b is None else jnp.asarray(b).astype(jdt)))
    got = tlayers.dense(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(w).to(tdt), mode,
                        None if b is None else torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(f32(got), want, rtol=rtol,
                               atol=1e-6 if rtol else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_bp8_match_reference(arch, rng):
    """bp8 projections over a bp8 cache: prefill, then 16 greedy decode
    steps, each side fed its own argmax."""
    jcfg, tcfg = configs(arch, "bp8", "bp8")
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    b, s, steps = 2, 8, 16
    toks = rng.integers(2, jcfg.vocab_size, size=(b, s))
    jb, tb = prefill_batches(jcfg, toks, rng)
    jl, jc = jjit(jm.prefill, static_argnums=2)(jp, jb, s + steps)
    tl, tc = tm.prefill(tp, tb, s + steps)
    dec = jjit(jm.decode_step)
    jtoks, ttoks = [], []
    for i in range(steps):
        jtoks.append(np.argmax(np.array(jl), -1))
        ttoks.append(tl.argmax(-1).numpy())
        pos = np.full((b,), s + jcfg.num_prefix_tokens + i, np.int32)
        jl, jc = dec(jp, jnp.asarray(jtoks[-1][:, None]), jc,
                     jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(ttoks[-1][:, None]), tc,
                                torch.from_numpy(pos))
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_unported_modes_raise():
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown matmul mode"):
        tlayers.dense(x, torch.zeros(64, 8), "int4")
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("mamba_2p8b")        # an arch neither package has
