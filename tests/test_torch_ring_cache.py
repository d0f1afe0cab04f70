"""Ring-buffer KV caches (``ring_cache=True``) against the JAX reference,
on the CPU, on h2o-danube's smoke config (a uniform window of 16).

A ring keeps ``min(length, window)`` slots a layer, addressed pos % n:
prefill writes the prompt's last n tokens there (attending the whole
prompt, as without the ring) and decode writes each token over the
oldest.  Parameters come from the reference's ``init_tree`` through
numpy; the reference is compiled as in ``test_torch_model.py``.

Tolerances: cache positions bitwise; bp8 caches (codes and scales)
bitwise, as ``test_torch_model.py`` holds them; bf16 caches within one
bf16 ulp of their largest value (a bf16 projection can round to the
neighbouring value); logits within ``test_torch_model.py``'s ``MODES``
tolerances; tokens equal.  The port's ring against its full cache:
prefill logits bitwise (both attend the whole prompt), decode logits
within the reference's own 2e-2 (``tests/test_models.py::
test_ring_cache_decode``: the softmax sums another number of slots in
another order).
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
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged_engine as tpe  # noqa: E402

from test_torch_gemma import _Recording, _same_calls  # noqa: E402
from test_torch_model import MODES, f32, ref_jit, to_np  # noqa: E402

ARCH = "h2o_danube_1p8b"
ENGINE_MODES = [m for m in MODES if m[0] in ("bf16", "bp8", "bp8_fused")]
WINDOW = 16

_PARAMS = {}


def ref_params():
    if not _PARAMS:
        jp = init_tree(jbuild(jget_config(ARCH, smoke=True)).schema(),
                       jax.random.key(0))
        _PARAMS["p"] = (jp, to_np(jp))
    return _PARAMS["p"]


_STACKS = {}


def stacks(mode="bp8_fused", kvq="bp8", ring=True):
    """((jcfg, jmodel, jparams), (tcfg, tmodel, tparams)), one object per
    (mode, kv_quant, ring) so the reference's compiles are shared."""
    key = (mode, kvq, ring)
    if key not in _STACKS:
        kw = dict(matmul_mode=mode, kv_quant=kvq, ring_cache=ring)
        jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), **kw)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
        assert tcfg.window_size == WINDOW
        jp, npp = ref_params()
        _STACKS[key] = ((jcfg, jbuild(jcfg), jp),
                        (tcfg, build(tcfg), params_from_numpy(npp, tcfg,
                                                              "cpu")))
    return _STACKS[key]


def _same_cache(tc, jc, kvq):
    want = dict((tuple(k.key for k in p), a) for p, a in
                jax.tree_util.tree_flatten_with_path(jc)[0])
    got = dict(tree_leaves(tc))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        w = f32(want[path])
        if kvq == "bp8" or path[-1] == "pos":
            np.testing.assert_array_equal(f32(leaf), w,
                                          err_msg="/".join(path))
        else:
            np.testing.assert_allclose(
                f32(leaf), w, rtol=0,
                atol=2.0 ** -8 * float(np.abs(w).max()),
                err_msg="/".join(path))


@pytest.mark.parametrize("mode,kvq,tol", ENGINE_MODES,
                         ids=[m[0] for m in ENGINE_MODES])
def test_ring_prefill_and_decode_match_reference(mode, kvq, tol):
    """A 2-row prefill of 24 tokens into a ring of 16 (the last 16 tokens
    at slots pos % 16), then 12 greedy decode steps past the wrap: the
    cache after every call, the logits of every call and the tokens
    against the reference's ring."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(mode, kvq)
    rng = np.random.default_rng(8)
    toks = rng.integers(2, jcfg.vocab_size, (2, 24))
    jl, jc = ref_jit(jm, "prefill", static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 64)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 64)
    assert tc["layers"]["pos"].shape == (tcfg.num_layers, 2, WINDOW)
    assert tc["layers"]["pos"][0, 0].tolist() == list(range(16, 24)) + \
        list(range(8, 16))
    _same_cache(tc, jc, kvq)
    np.testing.assert_allclose(f32(tl), f32(jl), rtol=0, atol=tol)
    dec = ref_jit(jm, "decode_step")
    for i in range(12):
        jt, tt = np.argmax(f32(jl), -1), f32(tl).argmax(-1)
        np.testing.assert_array_equal(tt, jt)
        pos = np.full((2,), 24 + i, np.int32)
        jl, jc = dec(jp, jnp.asarray(jt[:, None], jnp.int32), jc,
                     jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tt[:, None]), tc,
                                torch.from_numpy(pos))
        _same_cache(tc, jc, kvq)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=0, atol=tol)


@pytest.mark.parametrize("kvq", ["none", "bp8"])
def test_ring_matches_full_cache(kvq):
    """The reference's ``test_ring_cache_decode`` on the port: a ring of
    16 against a full cache of 64, prefill logits bitwise, then 3 decode
    steps past the prefill (wrapping the ring) within 2e-2 with the same
    greedy tokens."""
    mode = "bp8_fused" if kvq == "bp8" else "bf16"
    (_, _, _), (_, full, tp) = stacks(mode, kvq, ring=False)
    (_, _, _), (_, ring, _) = stacks(mode, kvq, ring=True)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        2, 512, (2, 32)))
    lf, cf = full.prefill(tp, {"tokens": toks}, 64)
    lr, cr = ring.prefill(tp, {"tokens": toks}, 64)
    assert cf["layers"]["pos"].shape[-1] == 64
    assert cr["layers"]["pos"].shape[-1] == WINDOW
    assert torch.equal(lr, lf)
    tok = lf.argmax(-1)[:, None]
    for i in range(3):
        p = torch.tensor(32 + i, dtype=torch.int32)
        gf, cf = full.decode_step(tp, tok, cf, p)
        gr, cr = ring.decode_step(tp, tok, cr, p)
        np.testing.assert_allclose(gr.numpy(), gf.numpy(), rtol=2e-2,
                                   atol=2e-2)
        assert torch.equal(gr.argmax(-1), gf.argmax(-1))
        tok = gf.argmax(-1)[:, None]


def test_ring_cache_write():
    """The reference's ``test_ring_cache_write``: six writes into a ring
    of 4 leave positions [4, 5, 2, 3]."""
    spec = {"k": ((1, 4, 2, 3), torch.bfloat16),
            "v": ((1, 4, 2, 3), torch.bfloat16),
            "pos": ((1, 4), torch.int32)}
    cache = {k: (torch.full(s, -1, dtype=d) if d == torch.int32 else
                 torch.zeros(s, dtype=d)) for k, (s, d) in spec.items()}
    k = torch.ones((1, 1, 2, 3), dtype=torch.bfloat16)
    for p in range(6):
        tattn._cache_write(cache, {"k": k * p, "v": k * p},
                           torch.tensor(p, dtype=torch.int32))
    assert cache["pos"][0].tolist() == [4, 5, 2, 3]
    assert cache["k"][0, :, 0, 0].tolist() == [4.0, 5.0, 2.0, 3.0]


def test_kv_cache_spec_ring_lengths():
    """A ring keeps min(length, window) slots; a short cache or a layer
    without a window keeps its length."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), kv_quant="bp8")
    for length, want in ((64, 16), (10, 10)):
        spec = tattn.kv_cache_spec(cfg, 2, length, ring=True)
        assert {k: s[1] for k, (s, _) in spec.items()} == {
            k: want for k in spec}
    nowin = dataclasses.replace(cfg, window_size=None)
    assert tattn.kv_cache_spec(nowin, 2, 64, ring=True)["pos"][0] == (2, 64)


@pytest.mark.parametrize("mode,kvq,tol", ENGINE_MODES[:2],
                         ids=[m[0] for m in ENGINE_MODES[:2]])
def test_lockstep_engine_ring_matches_reference(mode, kvq, tol):
    """The lock-step engine (2 slots, max_len 64) over rings of 16 against
    the reference's: prompts of 20, 7 and 12 tokens, 14 new each (past
    the wrap; request 2 refills a slot mid-stream); the tokens and every
    call's logits, and the static decode cache sized by the ring."""
    (jcfg, jm, jp), (tcfg, tm, tp) = stacks(mode, kvq)

    def reqs(mod):
        r = np.random.default_rng(12)
        return [mod.Request(rid=i, prompt=r.integers(
            2, jcfg.vocab_size, n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(((20, 14), (7, 14), (12, 14)))]

    jcalls, tcalls = [], []
    jrec = _Recording(jm, jcalls)
    ecfg = dict(slots=2, max_len=64)
    je = jeng.ServeEngine(jm, jp, jcfg, jeng.EngineConfig(**ecfg))
    je._decode = jrec._wrap("decode_step", ref_jit(jm, "decode_step"))
    je._prefill = jrec._wrap("prefill", ref_jit(jm, "prefill",
                                                static_argnums=2))
    want = je.run(reqs(jeng))
    te = teng.ServeEngine(_Recording(tm, tcalls), tp, tcfg,
                          teng.EngineConfig(**ecfg), device="cpu")
    got = te.run(reqs(teng))
    assert got == want
    assert all(len(v) == 14 for v in got.values())
    assert [n for n, _ in tcalls].count("prefill") >= 2
    _same_calls(tcalls, jcalls, tol)
    with torch.inference_mode():
        _, cache, _ = te._decode_inputs(2)
    assert cache["layers"]["pos"].shape == (tcfg.num_layers, 2, WINDOW)


def test_ring_refusals():
    """The paged cache and engine, chunked prefill, and a window that is
    not uniform (gemma3's local/global layers, or none) refuse a ring."""
    from repro_torch.serve.paged_cache import PagedCache
    (_, _, _), (tcfg, tm, tp) = stacks()
    with pytest.raises(ValueError, match="ring"):
        PagedCache(tm, slots=2, num_blocks=8, block_size=8, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tpe.PagedServeEngine(tm, tp, tcfg, tpe.PagedEngineConfig(),
                             device="cpu")
    cache = tm.init_cache(1, 64, "cpu")
    with pytest.raises(ValueError, match="ring"):
        tm.prefill_chunk(tp, {"tokens": torch.ones((1, 4),
                                                   dtype=torch.long)},
                         cache, 0)
    for arch, kw in (("gemma3_12b", {}), (ARCH, {"window_size": None})):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  ring_cache=True, **kw)
        with pytest.raises(ValueError, match="every layer windowed"):
            build(cfg).cache_spec(1, 64)
