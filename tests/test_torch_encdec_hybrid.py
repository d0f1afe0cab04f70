"""whisper (encoder-decoder) and zamba2 (Mamba2 with a shared attention
block) against the JAX reference, on the CPU.

Parameters are seeded numpy draws over the schema (the reference's,
leaf for leaf: ``test_params_from_numpy_carries_both_schemas``), every
leaf random: the init's zero leaves (zamba2's LoRA ``b_q``, ``a_log``,
``dt_bias``, ``conv_b``, the norms) would leave their paths untested.
They reach the reference as jax arrays and the port through
``params_from_numpy``.  The reference is compiled with
``xla_allow_excess_precision`` off (``test_torch_model.py``), its Pallas
kernels in interpret mode under ``bp8_fused``; each (arch, mode) keeps
one reference model object, so its compiles are shared by the tests.
whisper's frames are seeded random values, not the stub's zeros, so a
fault of the encoder shows: the port's engines read them from their
``frames`` buffer, the reference's from a wrapper of its entry points.

Tolerances (observed in brackets):
  * configs exactly; ``layer_norm`` f32 within 2e-6 (the mean and the
    variance reduce in another order than XLA's) [9.5e-7], bf16 within
    one bf16 ulp;
  * ``gqa_apply``'s new branches (non-causal, cross, no RoPE) within
    one bf16 ulp of the output, bp8 caches bitwise;
  * logits of every engine call (of ~30-50: the tied std-1 embeddings):
    ``test_torch_model.py``'s ``MODES`` tolerances times
    ``LOGIT_SCALE``, 8 for whisper and 32 for zamba2.  bp8_fused and bp8
    [<= 7.6e-6: the BP codes agree bit for bit, f32 reassociation is
    left]; bf16 [whisper 7.6e-6, zamba2 0.118; with the reference's
    init_tree weights 0.103 and 0.374]: bf16 matmuls accumulate in
    another order, and zamba2's SSM state carries a flipped bf16 value
    through every later token;
  * tokens equal; a chunked prefill (with a one-token chunk) against a
    one-shot prefill of the same tokens, the port alone in bf16: the
    bf16 logits tolerance above [0.0: the bf16 casts absorb the SSD's
    reassociation at this size].
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
from repro.models.params import is_def  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402

from test_torch_gemma import _Recording, _same_calls  # noqa: E402
from test_torch_model import EXACT, MODES, f32, jjit, to_np  # noqa: E402

ARCHS = ["whisper_base", "zamba2_2p7b"]
#: logits of ~30 (tied std-1 embeddings): MODES' tolerances scaled
LOGIT_SCALE = {"whisper_base": 8.0, "zamba2_2p7b": 32.0}
ENGINE_MODES = [m for m in MODES if m[0] in ("bf16", "bp8", "bp8_fused")]
PAGED = dict(slots=2, block_size=8, num_blocks=16, max_prefill_tokens=4)
LOCKSTEP = dict(slots=2, max_len=16)


def _draw(d, rng):
    """One leaf: normal at the init's std (``scale / sqrt(fan_in)``, 1 for
    embeddings), zeros and ones leaves perturbed by N(0, 0.1^2)."""
    x = rng.normal(size=d.shape).astype(np.float32)
    if d.init == "embed":
        return x
    if d.init in ("zeros", "ones"):
        return x * 0.1 + (1.0 if d.init == "ones" else 0.0)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return x * (d.scale / np.sqrt(max(1, fan_in)))


_PARAMS = {}


def seeded(arch):
    """(reference params, numpy params) of the smoke arch, drawn once."""
    if arch not in _PARAMS:
        rng = np.random.default_rng(7)
        schema = jbuild(jget_config(arch, smoke=True)).schema()
        jp = jax.tree.map(lambda d: jnp.asarray(_draw(d, rng)).astype(
            d.dtype), schema, is_leaf=is_def)
        _PARAMS[arch] = (jp, to_np(jp))
    return _PARAMS[arch]


_STACKS = {}


def stacks(arch, mode="bp8_fused", kvq="bp8"):
    """((jcfg, jmodel, jparams), (tcfg, tmodel, tparams)), one object per
    (arch, mode) so the reference's compiles are shared."""
    key = (arch, mode, kvq)
    if key not in _STACKS:
        jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                                   matmul_mode=mode, kv_quant=kvq)
        tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   matmul_mode=mode, kv_quant=kvq)
        jp, npp = seeded(arch)
        _STACKS[key] = ((jcfg, jbuild(jcfg), jp),
                        (tcfg, build(tcfg), params_from_numpy(npp, tcfg,
                                                              "cpu")))
    return _STACKS[key]


def frames_of(cfg, seed=3):
    """Seeded (1, F, d_model) frame embeddings, as bf16 on both sides."""
    fr = np.random.default_rng(seed).normal(
        size=(1, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return jnp.asarray(fr).astype(jnp.bfloat16), torch.from_numpy(fr).to(
        torch.bfloat16)


def _with_frames(fn, jfr):
    """The reference entry ``fn`` with the batch's stub frames replaced by
    ``jfr`` (broadcast over the batch)."""
    def call(params, batch, *rest):
        if "frames" in batch:
            f = batch["frames"]
            batch = dict(batch, frames=jnp.broadcast_to(jfr, f.shape))
        return fn(params, batch, *rest)
    return call


# ---------------------------------------------------------------------------
# configs, layer_norm, the schemas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch, smoke):
    t, j = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.family == {"whisper_base": "encdec",
                        "zamba2_2p7b": "hybrid"}[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 512])
def test_layer_norm_matches_reference(d, dtype, rng):
    x = (rng.normal(size=(3, 7, d)) * 3 + 1).astype(np.float32)
    g, b = (rng.normal(size=d).astype(np.float32) for _ in range(2))
    want = f32(jjit(jlayers.layer_norm)(jnp.asarray(x).astype(dtype), g, b))
    got = tlayers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), want, rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(f32(got), want, rtol=2 ** -8, atol=0)
    ln = tlayers.ln_defs(d)
    assert (ln["gamma"].init, ln["beta"].init) == ("ones", "zeros")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_both_schemas(arch):
    """The port's schema is the reference's leaf for leaf (paths, shapes,
    dtypes, init rules); the converter carries every leaf's values."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jschema = dict(
        (tuple(k.key for k in path), d) for path, d in
        jax.tree_util.tree_flatten_with_path(
            jbuild(jcfg).schema(), is_leaf=is_def)[0])
    tschema = dict(tree_leaves(build(tcfg).schema()))
    assert sorted(tschema) == sorted(jschema)
    for path, d in tschema.items():
        j = jschema[path]
        assert (d.shape, d.axes, d.init, d.scale) == (
            j.shape, j.axes, j.init, j.scale), path
        assert str(d.dtype).split(".")[-1] == str(np.dtype(j.dtype)), path
    jp, npp = seeded(arch)
    tp = dict(tree_leaves(params_from_numpy(npp, tcfg, "cpu")))
    want = dict((tuple(k.key for k in path), a) for path, a in
                jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, leaf in tp.items():
        np.testing.assert_array_equal(f32(leaf), f32(want[path]),
                                      err_msg="/".join(path))


# ---------------------------------------------------------------------------
# gqa_apply: non-causal, cross attention, no RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvq", ["none", "bp8"])
def test_gqa_apply_cross_noncausal_and_norope(kvq, rng):
    """whisper's three uses: the encoder (no cache, non-causal, no RoPE)
    and cross attention over given K/V (both without a cache, so once),
    and decoder self-attention without RoPE through a prefill, a chunk
    and decode steps (over a bp8 cache: decode through the fused
    kernel's plain version, causal)."""
    jcfg = dataclasses.replace(jget_config("whisper_base", smoke=True),
                               matmul_mode="bp8_fused", kv_quant=kvq)
    tcfg = dataclasses.replace(get_config("whisper_base", smoke=True),
                               matmul_mode="bp8_fused", kv_quant=kvq)
    npp = seeded("whisper_base")[1]["dec_layers"]["self_attn"]
    jp = {k: jnp.asarray(v[0]).astype(jnp.bfloat16) for k, v in npp.items()}
    tp = {k: torch.from_numpy(v[0]).bfloat16() for k, v in npp.items()}
    b, d = 2, jcfg.d_model

    def check(got, want):
        np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -8,
                                   atol=1e-6)

    x = rng.normal(size=(b, 12, d)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    if kvq == "none":      # the encoder and cross attention keep no cache
        jo, _ = jjit(lambda p, x, pos: jattn.gqa_apply(
            p, jcfg, x, pos, window=None, causal=False, rope=False))(
            jp, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos))
        to, _ = tattn.gqa_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(pos), window=None,
                                causal=False, rope=False)
        check(to, jo)
        causal, _ = tattn.gqa_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(pos), window=None,
                                    rope=False)
        assert not torch.equal(causal, to)        # the mask mattered

        ck, cv = (rng.normal(size=(b, 20, jcfg.num_kv_heads, jcfg.head_dim)
                             ).astype(np.float32) for _ in range(2))
        xq = rng.normal(size=(b, 3, d)).astype(np.float32)
        qpos = np.tile(np.arange(5, 8, dtype=np.int32), (b, 1))
        jo, jc = jjit(lambda p, x, pos, k, v: jattn.gqa_apply(
            p, jcfg, x, pos, window=None, cross_kv=(k, v), rope=False))(
            jp, jnp.asarray(xq).astype(jnp.bfloat16), jnp.asarray(qpos),
            jnp.asarray(ck).astype(jnp.bfloat16),
            jnp.asarray(cv).astype(jnp.bfloat16))
        to, tc = tattn.gqa_apply(tp, tcfg, torch.from_numpy(xq).bfloat16(),
                                 torch.from_numpy(qpos), window=None,
                                 cross_kv=(torch.from_numpy(ck).bfloat16(),
                                           torch.from_numpy(cv).bfloat16()),
                                 rope=False)
        assert jc is None and tc is None
        check(to, jo)

    jcache = jattn.init_cache(jattn.kv_cache_spec(jcfg, b, 24))
    spec = tattn.kv_cache_spec(tcfg, b, 24)
    tcache = {k: torch.from_numpy(f32(v)).to(spec[k][1])
              for k, v in jcache.items()}
    fns = {append: jjit(lambda p, x, pos, c, append=append: jattn.gqa_apply(
        p, jcfg, x, pos, window=None, cache=c, rope=False, append=append))
        for append in (False, True)}

    def step(x, pos, append=False):
        nonlocal jcache
        jo, jcache = fns[append](jp, jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(pos), jcache)
        to, _ = tattn.gqa_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(pos), window=None,
                                cache=tcache, rope=False, append=append)
        check(to, jo)
        for k in jcache:
            np.testing.assert_array_equal(f32(tcache[k]), f32(jcache[k]),
                                          err_msg=k)

    step(x, np.tile(pos, (b, 1)))                                 # prefill
    step(rng.normal(size=(b, 4, d)).astype(np.float32),
         np.tile(np.arange(12, 16, dtype=np.int32), (b, 1)), True)  # chunk
    for p in (16, 17):                                            # decode
        step(rng.normal(size=(b, 1, d)).astype(np.float32),
             np.array([[p], [p]], np.int32))


# ---------------------------------------------------------------------------
# both engines, every call's logits, in bf16, bp8 and bp8_fused
# ---------------------------------------------------------------------------

def _engine_requests(mod, vocab, paged):
    """Three requests through two slots.  Paged: prompts of 5 tokens in
    chunks of 4 (the first carries the frames) and 1 (a one-token chunk,
    which reads the cross K/V from the cache and takes Mamba2's
    recurrent step), 3 new tokens.  Lock-step: request 2 refills request
    0's slot mid-stream (its cache row, cross K/V and states scattered)."""
    rng = np.random.default_rng(11)
    if paged:
        specs = [(5, 3), (5, 3), (5, 3)]
        return [mod.PagedRequest(rid=i, prompt=rng.integers(
            2, vocab, n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(specs)]
    specs = [(5, 2), (5, 4), (3, 2)]
    return [mod.Request(rid=i, prompt=rng.integers(2, vocab, n).astype(
        np.int32), max_new_tokens=m) for i, (n, m) in enumerate(specs)]


@pytest.mark.parametrize("mode,kvq,tol", ENGINE_MODES,
                         ids=[m[0] for m in ENGINE_MODES])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference(arch, mode, kvq, tol):
    """The paged engine and the lock-step engine against the reference's:
    the same greedy tokens, steps and prefill shapes, and the logits of
    every model call (prefill chunks with and without frames, the
    one-token chunks, prefills, decode steps)."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(arch, mode, kvq)
    tol = tol * LOGIT_SCALE[arch]
    encdec = jcfg.family == "encdec"
    jfr, tfr = frames_of(jcfg) if encdec else (None, None)

    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**PAGED))
    je._decode = jrec._wrap("decode_step", jjit(jm.decode_step))
    je._prefill_chunk = jrec._wrap("prefill_chunk", _with_frames(
        jjit(jm.prefill_chunk), jfr))
    want = je.run(_engine_requests(jpe, jcfg.vocab_size, True))
    te = tpe.PagedServeEngine(_Recording(tm, tcalls), tp, tcfg,
                              tpe.PagedEngineConfig(**PAGED), device="cpu")
    if encdec:
        te.frames.copy_(tfr)
    got = te.run(_engine_requests(tpe, tcfg.vocab_size, True))
    assert got == want
    assert te.step_count == je.step_count
    assert te.stats.prefill_shapes == je.stats.prefill_shapes
    assert (4, 8, encdec) in te.stats.prefill_shapes
    assert (1, 8, False) in te.stats.prefill_shapes
    counts, bounds = te.compile_counts(), te.compile_shape_bounds()
    assert bounds == je.compile_shape_bounds()
    assert all(counts[k] <= bounds[k] for k in bounds)
    _same_calls(tcalls, jcalls, tol)
    # every slot was freed and scrubbed: its dense rows read as fresh
    for path, leaf, bi, is_kv in te.cache.leaves():
        if not is_kv:
            assert not leaf.any(), path

    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    je = jeng.ServeEngine(jm, jp, jcfg, jeng.EngineConfig(**LOCKSTEP))
    je._decode = jrec._wrap("decode_step", jjit(jm.decode_step))
    je._prefill = jrec._wrap("prefill", _with_frames(
        jjit(jm.prefill, static_argnums=2), jfr))
    want = je.run(_engine_requests(jeng, jcfg.vocab_size, False))
    te = teng.ServeEngine(_Recording(tm, tcalls), tp, tcfg,
                          teng.EngineConfig(**LOCKSTEP), device="cpu")
    if encdec:
        te.frames.copy_(tfr)
    got = te.run(_engine_requests(teng, tcfg.vocab_size, False))
    assert got == want
    assert [len(got[i]) for i in range(3)] == [2, 4, 2]
    # the first generation's prefill and request 2's refill
    assert [n for n, _ in tcalls].count("prefill") == 2
    _same_calls(tcalls, jcalls, tol)


# ---------------------------------------------------------------------------
# the port alone: chunked == one-shot prefill, slot reuse scrubbed, the
# paged cache's dense leaves, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_one_shot(arch):
    """A prompt of 12 tokens prefilled at once, and in chunks of 8, 3 and
    a one-token chunk (whisper: the frames with the first), give the
    same last logits and then the same decode logits (bf16 mode: the BP
    scale of bp8_fused spans a call's rows, so a chunk quantises
    otherwise), within the bf16 logits tolerance; the greedy tokens
    agree."""
    (_, _, _), (tcfg, tm, tp) = stacks(arch, "bf16", "none")
    tol = dict((m[0], m[2]) for m in MODES)["bf16"] * LOGIT_SCALE[arch]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        2, tcfg.vocab_size, (1, 13)))
    batch = {"tokens": toks[:, :12]}
    if tcfg.family == "encdec":
        batch["frames"] = frames_of(tcfg)[1]
    whole, wc = tm.prefill(tp, batch, 16)
    cache = tm.init_cache(1, 16, "cpu")
    pos = 0
    for n in (8, 3, 1):
        chunk = {"tokens": toks[:, pos:pos + n]}
        if pos == 0 and "frames" in batch:
            chunk["frames"] = batch["frames"]
        part, cache = tm.prefill_chunk(tp, chunk, cache, pos)
        pos += n
    np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=0,
                               atol=tol)
    assert int(part.argmax()) == int(whole.argmax())
    p = torch.tensor([12], dtype=torch.int32)
    a, _ = tm.decode_step(tp, toks[:, 12:13], wc, p)
    b, _ = tm.decode_step(tp, toks[:, 12:13], cache, p)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_pool_reuse_is_scrubbed(arch):
    """The reference's case: a warm engine's second batch (slots and
    blocks freed by the first, reused) matches a fresh engine's."""
    (_, _, _), (tcfg, tm, tp) = stacks(arch)
    rng = np.random.default_rng(2)

    def reqs(base):
        return [tpe.PagedRequest(rid=base + i, prompt=rng.integers(
            2, tcfg.vocab_size, n).astype(np.int32), max_new_tokens=3)
            for i, n in enumerate((6, 3, 5))]

    first, second = reqs(0), reqs(10)
    warm = tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(**PAGED),
                                device="cpu")
    warm.run(first)
    again = warm.run([dataclasses.replace(r, out_tokens=[])
                      for r in second])
    fresh = tpe.PagedServeEngine(tm, tp, tcfg,
                                 tpe.PagedEngineConfig(**PAGED),
                                 device="cpu").run(second)
    assert again == fresh
    assert warm.cache.free_blocks == warm.cache.allocator.num_blocks - 1


def test_paged_cache_dense_leaves():
    """zamba2's cache through the pool: the attention leaves are paged,
    the Mamba2 states dense per slot.  A gather reads the slots' rows
    (a repeated slot for padding), a commit writes only the listed rows,
    and ``free_slot`` zeroes the slot's rows."""
    from repro_torch.serve.paged_cache import PagedCache
    (_, _, _), (tcfg, tm, _) = stacks("zamba2_2p7b")
    pc = PagedCache(tm, slots=3, num_blocks=6, block_size=4, device="cpu")
    kinds = {"/".join(p): kv for p, _, _, kv in pc.leaves()}
    assert kinds == {"attn/k_codes": True, "attn/k_scale": True,
                     "attn/pos": True, "attn/v_codes": True,
                     "attn/v_scale": True, "mamba/conv": False,
                     "mamba/ssm": False}
    ssm = dict((p, leaf) for p, leaf, _, _ in pc.leaves())[("mamba", "ssm")]
    g, per = tcfg.num_layers // tcfg.attn_every, tcfg.attn_every
    assert ssm.shape == (g, per, 3) + ssm.shape[3:]
    for s in range(3):
        pc.alloc_slot(s, 1)
    view = pc.gather([2, 0], 4)
    assert view["mamba"]["ssm"].shape == (g, per, 2) + ssm.shape[3:]
    assert view["attn"]["pos"].shape == (g, 2, 4)
    view["mamba"]["ssm"][:, :, 0] = 2.0
    view["mamba"]["ssm"][:, :, 1] = 5.0           # a padding row
    pc.commit_decode(view, [0], [2], [0])
    assert (ssm[:, :, 2] == 2.0).all() and not ssm[:, :, :2].any()
    one = pc.gather([1], 4)
    one["mamba"]["conv"].fill_(3.0)
    pc.commit_prefill(one, 1, 0, 2)
    conv = dict((p, leaf) for p, leaf, _, _ in pc.leaves())[("mamba",
                                                               "conv")]
    assert (conv[:, :, 1] == 3.0).all()
    again = pc.gather([2, 2, 1], 4)
    assert (again["mamba"]["ssm"][:, :, :2] == 2.0).all()
    pc.free_slot(2)
    pc.free_slot(1)
    assert not ssm.any() and not conv.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_training_runs_encdec_and_hybrid(arch):
    """Both families train (``tests/test_torch_train_families.py`` holds
    them to the reference): a step over ``demo_batch`` moves the
    params; ``train`` trains zamba2 from the data pipeline, and fails
    for whisper, whose pipeline batches carry no frames, as the
    reference's does."""
    import math
    from repro_torch.launch.inputs import demo_batch
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (TrainPlan, init_state,
                                              make_train_step)
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = get_config(arch, smoke=True)
    model = build(cfg)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=2)
    shape = ShapeConfig("t", "train", 8, 2)
    state = init_state(model, 0, opt, "cpu")
    new, m = make_train_step(model, opt, TrainPlan(1, 2))(
        state, demo_batch(cfg, shape, device="cpu"))
    assert math.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert not torch.equal(new["params"]["embed"], state["params"]["embed"])
    if cfg.family == "encdec":
        with pytest.raises(KeyError, match="frames"):
            train(model, cfg, shape, TrainerConfig(total_steps=1),
                  device="cpu")
        return
    _, hist = train(model, cfg, shape, TrainerConfig(total_steps=1),
                    device="cpu")
    assert [h["step"] for h in hist] == [1]
    assert math.isfinite(hist[0]["loss"])
