"""xlstm (mLSTM and sLSTM blocks) against the JAX reference, on the CPU.

Parameters come from the reference's ``init_tree`` and cross through
numpy (``params_from_numpy``); inputs and states are seeded numpy draws.
The reference is compiled with ``xla_allow_excess_precision`` off
(``test_torch_model.py``), its Pallas kernels in interpret mode under
``bp8_fused``; its compiled entry points are shared across the cases
through ``test_torch_model.ref_jit``.

Tolerances (observed in brackets):
  * configs exactly;
  * ``mlstm_apply`` and ``slstm_apply`` in f32: outputs and states
    within 1e-5 of the reference's largest magnitude (the contractions
    and the cumulative sums reduce in another order) [<= 6e-7
    relative]; in bf16 the outputs within one bf16 ulp of their largest
    magnitude (a bf16 projection can round to the neighbouring value)
    and the f32 states within 1e-5 as in f32;
  * the reference's own cases (``tests/test_ssm.py``) at their own
    tolerances, 5e-3;
  * logits of every model and engine call (up to ~52: the tied std-1
    embedding): ``test_torch_model.py``'s ``MODES`` tolerances times
    ``LOGIT_SCALE`` 16, the Gemma family's scale for logits of ~55
    [bp8_fused and bp8 <= 7.6e-6: the BP codes agree bit for bit; bf16
    0.183 on the paged engine: a bf16 matmul that accumulates in another
    order rounds to the neighbouring value, and the recurrent state
    carries it into every later token, as zamba2's does];
  * tokens equal; a chunked prefill against a one-shot prefill, the
    port alone in bf16: the bf16 logits tolerance above.
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.params import init_tree, is_def  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import paged_engine as jpe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402

from test_torch_gemma import _Recording, _same_calls  # noqa: E402
from test_torch_model import MODES, f32, jjit, ref_jit, to_np  # noqa: E402

ARCH = "xlstm_1p3b"
#: logits of up to ~52 (tied std-1 embeddings): MODES' tolerances scaled
LOGIT_SCALE = 16.0
ENGINE_MODES = [m for m in MODES if m[0] in ("bf16", "bp8", "bp8_fused")]
PAGED = dict(slots=2, block_size=8, num_blocks=16, max_prefill_tokens=8)
LOCKSTEP = dict(slots=2, max_len=64)
BF16_ULP = 2.0 ** -8


_PARAMS = {}


def ref_params():
    """(reference params, numpy params) of the smoke config, from the
    reference's ``init_tree``, made once."""
    if not _PARAMS:
        jp = init_tree(jbuild(jget_config(ARCH, smoke=True)).schema(),
                       jax.random.key(0))
        _PARAMS["p"] = (jp, to_np(jp))
    return _PARAMS["p"]


_STACKS = {}


def stacks(mode="bp8_fused"):
    """((jcfg, jmodel, jparams), (tcfg, tmodel, tparams)), one object per
    mode so the reference's compiles are shared."""
    if mode not in _STACKS:
        jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                                   matmul_mode=mode)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                                   matmul_mode=mode)
        jp, npp = ref_params()
        _STACKS[mode] = ((jcfg, jbuild(jcfg), jp),
                         (tcfg, build(tcfg), params_from_numpy(npp, tcfg,
                                                               "cpu")))
    return _STACKS[mode]


# ---------------------------------------------------------------------------
# configs and the schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_reference_field_for_field(smoke):
    t, j = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.family == "xlstm"
    assert tssm.mlstm_inner(t) == jssm.mlstm_inner(j)
    if not smoke:
        assert tssm.mlstm_inner(t) == 2752


def test_params_from_numpy_carries_the_schema():
    """The port's schema is the reference's leaf for leaf (paths, shapes,
    dtypes, init rules, axes); the converter carries every value."""
    jcfg, tcfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
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
    jp, npp = ref_params()
    tp = dict(tree_leaves(params_from_numpy(npp, tcfg, "cpu")))
    want = dict((tuple(k.key for k in path), a) for path, a in
                jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, leaf in tp.items():
        np.testing.assert_array_equal(f32(leaf), f32(want[path]),
                                      err_msg="/".join(path))


# ---------------------------------------------------------------------------
# mlstm_apply and slstm_apply against the reference
# ---------------------------------------------------------------------------

_BLOCKS = {}


def block_params(kind):
    """(jcfg, tcfg, reference params, port params) of one block of the
    smoke config, from ``init_tree``."""
    if kind not in _BLOCKS:
        jcfg, tcfg = jget_config(ARCH, smoke=True), get_config(ARCH,
                                                               smoke=True)
        jdefs = (jssm.mlstm_defs if kind == "mlstm" else jssm.slstm_defs)(
            jcfg)
        tdefs = (tssm.mlstm_defs if kind == "mlstm" else tssm.slstm_defs)(
            tcfg)
        jp = init_tree(jdefs, jax.random.key(1))
        # the init's zero norm gains perturbed, so the gain is exercised
        jp = dict(jp, norm=jp["norm"] + 0.1 * jax.random.normal(
            jax.random.key(2), jp["norm"].shape))
        tp = {k: torch.from_numpy(v).to(tdefs[k].dtype)
              for k, v in to_np(jp).items()}
        _BLOCKS[kind] = (jcfg, tcfg, jp, tp)
    return _BLOCKS[kind]


def _apply(kind):
    return ((jssm.mlstm_apply, tssm.mlstm_apply) if kind == "mlstm" else
            (jssm.slstm_apply, tssm.slstm_apply))


def _state_spec(kind, cfg, b):
    spec = (tssm.mlstm_state_spec if kind == "mlstm"
            else tssm.slstm_state_spec)(cfg, b)
    return {k: shape for k, (shape, _) in spec.items()}


def _random_state(kind, cfg, b, rng):
    """A seeded state as the blocks leave one: m of either sign, n > 0."""
    out = {}
    for k, shape in _state_spec(kind, cfg, b).items():
        x = rng.normal(size=shape).astype(np.float32)
        if k == "n" and kind == "slstm":
            x = np.abs(x) + 0.5
        out[k] = x * (0.3 if k == "C" else 1.0)
    return out


def _start(kind, cfg, b, how):
    """The numpy start state: the reference's prefill start (zeros), the
    reference's own recurrent start (m = -1e30 for mLSTM, n = 1 for
    sLSTM), or a seeded state."""
    spec = _state_spec(kind, cfg, b)
    if how == "zeros":
        return {k: np.zeros(s, np.float32) for k, s in spec.items()}
    if how == "init":
        fill = {"m": -1e30} if kind == "mlstm" else {"n": 1.0}
        return {k: np.full(s, fill.get(k, 0.0), np.float32)
                for k, s in spec.items()}
    return _random_state(kind, cfg, b, np.random.default_rng(9))


def _check(got, want, dtype, what):
    scale = float(np.abs(want).max())
    tol = (BF16_ULP if dtype == "bfloat16" and what == "out" else 1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _run_both(kind, x, state, dtype, chunk=None):
    """One call of the block on both sides; returns ((jy, jstate),
    (ty, tstate)) as f32 numpy."""
    jcfg, tcfg, jp, tp = block_params(kind)
    japply, tapply = _apply(kind)
    kw = {} if chunk is None else {"chunk": chunk}
    fn = jjit(lambda p, x, st: japply(p, jcfg, x, state=st, **kw))
    jx = jnp.asarray(x).astype(dtype)
    js = None if state is None else {k: jnp.asarray(v)
                                     for k, v in state.items()}
    jy, jst = fn(jp, jx, js)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts = None if state is None else {k: torch.from_numpy(v.copy())
                                     for k, v in state.items()}
    ty, tst = tapply(tp, tcfg, tx, state=ts, **kw)
    assert ty.dtype == tx.dtype
    tonp = (lambda st: None if st is None else
            {k: f32(v) for k, v in st.items()})
    return (f32(jy), tonp(jst)), (f32(ty), tonp(tst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", ["fresh", "zeros", "init", "state"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_reference(kind, start, dtype):
    """A 12-token call (mLSTM in chunks of 4, so the loop over chunks
    carries a state) from the fresh start (``state=None``: no state out),
    from the zero state (the reference's prefill), from the reference's
    recurrent start, and from a seeded state; then, from the state it
    left, a one-token call (the recurrent branch) and one more 4-token
    call.  Outputs and every state leaf against the reference."""
    jcfg, tcfg, _, _ = block_params(kind)
    rng = np.random.default_rng(3)
    b = 2
    chunk = 4 if kind == "mlstm" else None
    state = None if start == "fresh" else _start(kind, tcfg, b, start)
    for s in (12, 1, 4):
        x = (rng.normal(size=(b, s, tcfg.d_model)) * 0.5).astype(np.float32)
        (jy, jst), (ty, tst) = _run_both(kind, x, state, dtype, chunk)
        _check(ty, jy, dtype, "out")
        if state is None:
            assert jst is None and tst is None
            return
        assert sorted(tst) == sorted(jst)
        for k in jst:
            _check(tst[k], jst[k], dtype, k)
        state = jst


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_token_by_token_matches_one_call(kind):
    """The port alone, in f32: 10 one-token steps from the reference's
    recurrent start give the outputs of one 10-token call without a
    state (mLSTM in chunks of 5), within 1e-5 of their largest value."""
    _, tcfg, _, tp = block_params(kind)
    _, tapply = _apply(kind)
    x = torch.from_numpy((np.random.default_rng(4).normal(
        size=(2, 10, tcfg.d_model)) * 0.5).astype(np.float32))
    kw = {"chunk": 5} if kind == "mlstm" else {}
    whole, none = tapply(tp, tcfg, x, state=None, **kw)
    assert none is None
    state = {k: torch.from_numpy(v)
             for k, v in _start(kind, tcfg, 2, "init").items()}
    steps = []
    for t in range(10):
        y, state = tapply(tp, tcfg, x[:, t:t + 1], state=state)
        steps.append(y)
    got = torch.cat(steps, dim=1)
    tol = 1e-5 * float(whole.abs().max())
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=tol)


def test_mlstm_refuses_a_length_off_its_chunk():
    _, tcfg, _, tp = block_params("mlstm")
    x = torch.zeros((1, 12, tcfg.d_model))
    with pytest.raises(ValueError, match="not a multiple of its chunk"):
        tssm.mlstm_apply(tp, tcfg, x, chunk=8)
    with pytest.raises(ValueError, match="not a multiple of its chunk"):
        tssm.mlstm_apply(tp, tcfg, torch.zeros((1, 300, tcfg.d_model)),
                         state={k: torch.from_numpy(v) for k, v in _start(
                             "mlstm", tcfg, 1, "zeros").items()})
    y, _ = tssm.mlstm_apply(tp, tcfg, x, chunk=6)       # 12 = 2 x 6
    assert y.shape == x.shape


# the reference's own cases (tests/test_ssm.py), run on the port with the
# reference's init_tree weights and its tolerances

def _ref_case_cfg():
    kw = dict(name="t", family="xlstm", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=4, head_dim=8, d_ff=0,
              vocab_size=128, slstm_every=2)
    return JModelConfig(**kw), ModelConfig(**kw)


def _ref_case_params(kind):
    jcfg, tcfg = _ref_case_cfg()
    jdefs = (jssm.mlstm_defs if kind == "mlstm" else jssm.slstm_defs)(jcfg)
    tdefs = (tssm.mlstm_defs if kind == "mlstm" else tssm.slstm_defs)(tcfg)
    jp = init_tree(jdefs, jax.random.key(0))
    return tcfg, {k: torch.from_numpy(v).to(tdefs[k].dtype)
                  for k, v in to_np(jp).items()}


def test_reference_case_mlstm_chunked_matches_recurrent(rng):
    cfg, p = _ref_case_params("mlstm")
    x = torch.from_numpy((rng.standard_normal((2, 12, cfg.d_model))
                          * 0.5).astype(np.float32))
    full, _ = tssm.mlstm_apply(p, cfg, x, state=None, chunk=4)
    state = {k: (torch.zeros(s) if k != "m" else torch.full(s, -1e30))
             for k, (s, _) in tssm.mlstm_state_spec(cfg, 2).items()}
    for t in range(12):
        out_t, state = tssm.mlstm_apply(p, cfg, x[:, t:t + 1], state=state)
        np.testing.assert_allclose(out_t[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_reference_case_mlstm_chunk_invariance(rng):
    cfg, p = _ref_case_params("mlstm")
    x = torch.from_numpy((rng.standard_normal((1, 16, cfg.d_model))
                          * 0.5).astype(np.float32))
    a, _ = tssm.mlstm_apply(p, cfg, x, state=None, chunk=4)
    b, _ = tssm.mlstm_apply(p, cfg, x, state=None, chunk=16)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-3)


def test_reference_case_slstm_decode_matches_full(rng):
    cfg, p = _ref_case_params("slstm")
    x = torch.from_numpy((rng.standard_normal((2, 10, cfg.d_model))
                          * 0.5).astype(np.float32))
    full, _ = tssm.slstm_apply(p, cfg, x, state=None)
    state = {k: (torch.ones(s) if k == "n" else torch.zeros(s))
             for k, (s, _) in tssm.slstm_state_spec(cfg, 2).items()}
    for t in range(10):
        out_t, state = tssm.slstm_apply(p, cfg, x[:, t:t + 1], state=state)
        np.testing.assert_allclose(out_t[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# XLSTMModel: every call's logits, in bf16, bp8 and bp8_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,kvq,tol", ENGINE_MODES,
                         ids=[m[0] for m in ENGINE_MODES])
def test_model_logits_match_reference(mode, kvq, tol):
    """A 2-row prefill of 8 tokens (the zero state), a 4-token chunk and a
    one-token chunk continuing it, then 6 decode steps on the greedy
    tokens: the logits of every call and the cache after each, and the
    greedy tokens equal."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(mode)
    tol = tol * LOGIT_SCALE
    rng = np.random.default_rng(6)
    toks = rng.integers(2, jcfg.vocab_size, (2, 13))
    jl, jc = ref_jit(jm, "prefill", static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :8], jnp.int32)}, 16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])}, 16)
    chunk = ref_jit(jm, "prefill_chunk")

    def same(jl, tl, jc, tc):
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=0, atol=tol)
        want = dict((tuple(k.key for k in p), a) for p, a in
                    jax.tree_util.tree_flatten_with_path(jc)[0])
        got = dict(tree_leaves(tc))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            w = f32(want[path])
            np.testing.assert_allclose(
                f32(leaf), w, rtol=0,
                atol=max(1e-5, tol / 30) * max(1.0, float(np.abs(w).max())),
                err_msg="/".join(path))

    same(jl, tl, jc, tc)
    for a, b in ((8, 12), (12, 13)):
        jl, jc = chunk(jp, {"tokens": jnp.asarray(toks[:, a:b], jnp.int32)},
                       jc, jnp.int32(a))
        tl, tc = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(
            toks[:, a:b])}, tc, torch.tensor(a))
        same(jl, tl, jc, tc)
    dec = ref_jit(jm, "decode_step")
    for i in range(6):
        jt, tt = np.argmax(f32(jl), -1), f32(tl).argmax(-1)
        np.testing.assert_array_equal(tt, jt)
        pos = np.full((2,), 13 + i, np.int32)
        jl, jc = dec(jp, jnp.asarray(jt[:, None], jnp.int32), jc,
                     jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tt[:, None]), tc,
                                torch.from_numpy(pos))
        same(jl, tl, jc, tc)


def test_chunked_prefill_equals_one_shot():
    """A prompt of 12 tokens prefilled at once, and in chunks of 8, 3 and a
    one-token chunk from the zero state, give the same last logits and
    then the same decode logits (bf16 mode), within the bf16 logits
    tolerance; the greedy tokens agree."""
    (_, _, _), (tcfg, tm, tp) = stacks("bf16")
    tol = dict((m[0], m[2]) for m in MODES)["bf16"] * LOGIT_SCALE
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        2, tcfg.vocab_size, (1, 13)))
    whole, wc = tm.prefill(tp, {"tokens": toks[:, :12]}, 16)
    cache = tm.init_cache(1, 16, "cpu")
    assert all(not leaf.any() for _, leaf in tree_leaves(cache))
    pos = 0
    for n in (8, 3, 1):
        part, cache = tm.prefill_chunk(tp, {"tokens": toks[:, pos:pos + n]},
                                       cache, pos)
        pos += n
    np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=0,
                               atol=tol)
    assert int(part.argmax()) == int(whole.argmax())
    a, _ = tm.decode_step(tp, toks[:, 12:13], wc, 12)
    b, _ = tm.decode_step(tp, toks[:, 12:13], cache, 12)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=tol)


def test_cache_spec_and_axes_match_reference():
    """Nested stacks (group, block, batch): the reference's shapes, dtypes
    and axis names, for the smoke and the full config (the full one's
    slot: 42 x 4 x 688 x 688 f32 = 318.1 MB of mLSTM state)."""
    for smoke in (True, False):
        jm = jbuild(jget_config(ARCH, smoke=smoke))
        tm = build(get_config(ARCH, smoke=smoke))
        want = dict((tuple(k.key for k in p), s) for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        jm.cache_spec(3, 64))[0])
        got = dict(tree_leaves(tm.cache_spec(3, 64)))
        assert sorted(got) == sorted(want)
        for path, (shape, dtype) in got.items():
            assert shape == want[path].shape, path
            assert str(dtype).split(".")[-1] == str(want[path].dtype)
        jaxes = jm.cache_axes(3, 64)
        assert tm.cache_axes() == {k: dict(v) for k, v in jaxes.items()}
    c = dict(tree_leaves(tm.cache_spec(1, 1)))[("mlstm", "C")][0]
    assert c == (6, 7, 1, 4, 688, 688)
    assert np.prod(c) * 4 == 318_087_168


# ---------------------------------------------------------------------------
# both engines against the reference's
# ---------------------------------------------------------------------------

def _engine_requests(mod, vocab, paged):
    """Three requests of 5, 13 and 20 tokens, 6 new each, through two
    slots."""
    rng = np.random.default_rng(11)
    cls = mod.PagedRequest if paged else mod.Request
    return [cls(rid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=6) for i, n in enumerate((5, 13, 20))]


@pytest.mark.parametrize("mode", ["bf16", "bp8_fused"])
def test_engines_match_reference(mode):
    """The paged engine (2 slots, 16 blocks of 8, chunk 8) and the
    lock-step engine (2 slots, max_len 64) against the reference's: the
    same greedy tokens, steps and prefill shapes, and the logits of every
    model call; the paged slots freed and scrubbed to zeros."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(mode)
    tol = dict((m[0], m[2]) for m in MODES)[mode] * LOGIT_SCALE

    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**PAGED))
    je._decode = jrec._wrap("decode_step", ref_jit(jm, "decode_step"))
    je._prefill_chunk = jrec._wrap("prefill_chunk",
                                   ref_jit(jm, "prefill_chunk"))
    want = je.run(_engine_requests(jpe, jcfg.vocab_size, True))
    te = tpe.PagedServeEngine(_Recording(tm, tcalls), tp, tcfg,
                              tpe.PagedEngineConfig(**PAGED), device="cpu")
    got = te.run(_engine_requests(tpe, tcfg.vocab_size, True))
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    assert te.step_count == je.step_count
    assert te.stats.prefill_shapes == je.stats.prefill_shapes
    counts, bounds = te.compile_counts(), te.compile_shape_bounds()
    assert bounds == je.compile_shape_bounds()
    assert all(counts[k] <= bounds[k] for k in bounds)
    _same_calls(tcalls, jcalls, tol)
    for path, leaf, bi, is_kv in te.cache.leaves():
        assert not is_kv and not leaf.any(), path

    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    je = jeng.ServeEngine(jm, jp, jcfg, jeng.EngineConfig(**LOCKSTEP))
    je._decode = jrec._wrap("decode_step", ref_jit(jm, "decode_step"))
    je._prefill = jrec._wrap("prefill", ref_jit(jm, "prefill",
                                                static_argnums=2))
    want = je.run(_engine_requests(jeng, jcfg.vocab_size, False))
    te = teng.ServeEngine(_Recording(tm, tcalls), tp, tcfg,
                          teng.EngineConfig(**LOCKSTEP), device="cpu")
    got = te.run(_engine_requests(teng, tcfg.vocab_size, False))
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    _same_calls(tcalls, jcalls, tol)


def test_lockstep_refill_scatters_nested_states():
    """A refill's batch-1 state lands in its row of every nested leaf
    (group, block, batch) and nowhere else."""
    (_, _, _), (tcfg, tm, tp) = stacks("bf16")
    eng = teng.ServeEngine(tm, tp, tcfg, teng.EngineConfig(**LOCKSTEP),
                           device="cpu")
    axes = tm.cache_axes()
    cache = tm.init_cache(3, 8, "cpu")
    single = {k: {n: torch.full_like(v.narrow(axes[k][n].index("batch"),
                                              0, 1), 1.0 + i)
                  for i, (n, v) in enumerate(sorted(leaves.items()))}
              for k, leaves in cache.items()}
    eng._scatter_slot(cache, single, 1)
    for (path, leaf), (_, one) in zip(tree_leaves(cache),
                                      tree_leaves(single)):
        bi = axes[path[0]][path[1]].index("batch")
        assert torch.equal(leaf.select(bi, 1), one.select(bi, 0)), path
        assert not leaf.select(bi, 0).any() and not leaf.select(bi, 2).any()


def test_paged_cache_holds_only_dense_leaves():
    """xLSTM's cache through the pool: every leaf dense per slot, none
    pooled.  A gather reads the slots' rows (a repeated slot for
    padding), a commit writes only the listed rows, ``free_slot`` zeroes
    the slot's rows, and ``view_len`` and the engine's shape bounds are
    the reference's whatever the view holds."""
    from repro_torch.serve.paged_cache import PagedCache
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks("bf16")
    pc = PagedCache(tm, slots=3, num_blocks=6, block_size=4, device="cpu")
    kinds = {"/".join(p): kv for p, _, _, kv in pc.leaves()}
    assert kinds == {"mlstm/C": False, "mlstm/m": False, "mlstm/n": False,
                     "slstm/c": False, "slstm/h": False, "slstm/m": False,
                     "slstm/n": False}
    C = dict((p, leaf) for p, leaf, _, _ in pc.leaves())[("mlstm", "C")]
    g, per = tcfg.num_layers // tcfg.slstm_every, tcfg.slstm_every
    assert C.shape == (g, per - 1, 3) + C.shape[3:]
    for s in range(3):
        pc.alloc_slot(s, 1)
    assert pc.view_len(5) == 8 and pc.view_len(1) == 4
    view = pc.gather([2, 0], 4)
    assert view["mlstm"]["C"].shape == (g, per - 1, 2) + C.shape[3:]
    assert view["slstm"]["h"].shape[:2] == (g, 2)
    view["mlstm"]["C"][:, :, 0] = 2.0
    view["mlstm"]["C"][:, :, 1] = 5.0             # a padding row
    pc.commit_decode(view, [0], [2], [0])
    assert (C[:, :, 2] == 2.0).all() and not C[:, :, :2].any()
    one = pc.gather([1], 4)
    one["slstm"]["n"].fill_(3.0)
    pc.commit_prefill(one, 1, 0, 2)
    n = dict((p, leaf) for p, leaf, _, _ in pc.leaves())[("slstm", "n")]
    assert (n[:, 1] == 3.0).all() and not n[:, 0].any()
    again = pc.gather([2, 2, 1], 4)
    assert (again["mlstm"]["C"][:, :, :2] == 2.0).all()
    pc.free_slot(2)
    pc.free_slot(1)
    assert all(not leaf.any() for _, leaf, _, _ in pc.leaves())
    assert pc.free_blocks == 5 - 1
    te = tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(**PAGED),
                              device="cpu")
    je = jpe.PagedServeEngine(jm, jp, jcfg, jpe.PagedEngineConfig(**PAGED))
    assert te.compile_shape_bounds() == je.compile_shape_bounds()


def test_training_runs_xlstm():
    """xlstm trains (``tests/test_torch_train_families.py`` holds it to
    the reference): ``loss`` from the reference's fresh start, a step
    over ``demo_batch`` that moves the params, and ``train`` from the
    data pipeline."""
    import math
    from repro_torch.launch.inputs import demo_batch
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (TrainPlan, init_state,
                                              make_train_step)
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = get_config(ARCH, smoke=True)
    model = build(cfg)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=2)
    shape = ShapeConfig("t", "train", 8, 2)
    state = init_state(model, 0, opt, "cpu")
    batch = demo_batch(cfg, shape, device="cpu")
    with torch.no_grad():
        loss, metrics = model.loss(state["params"], batch)
    assert sorted(metrics) == ["loss"] and math.isfinite(float(loss))
    new, m = make_train_step(model, opt, TrainPlan(1, 2))(state, batch)
    assert float(m["loss"]) == float(loss) and float(m["grad_norm"]) > 0
    assert not torch.equal(new["params"]["embed"], state["params"]["embed"])
    _, hist = train(model, cfg, shape, TrainerConfig(total_steps=1),
                    device="cpu")
    assert [h["step"] for h in hist] == [1]
    assert math.isfinite(hist[0]["loss"])
