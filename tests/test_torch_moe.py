"""The port's mixture-of-experts layer against the JAX reference, on the CPU.

Parameters come from the reference's ``init_tree`` and cross through
numpy; inputs from numpy seeds.  The reference is compiled with
``xla_allow_excess_precision`` off.  Its routing is read by a
transcription of ``src/repro/models/moe.py``'s routing lines (``jroute``
below), since ``moe_apply`` returns only the output and the aux loss.

Tolerances:
  * top-k experts, ranks within the expert, the kept mask and the
    per-expert counts — exact, ties included;
  * top-k weights within 2e-6 relative (observed 8 f32 ulps, 4.8e-7) and
    the aux loss within 2 f32 ulps (observed 1): the router's f32 matmul,
    the softmax's sum and the gates' mean reduce in other orders;
  * the output — f32: within 2e-6 absolute on outputs of magnitude ~1
    (observed <= 7.2e-7, with 30-90% of the elements bitwise); bf16: at
    most one bf16 ulp of the reference's value (observed: 99.97% bitwise,
    the rest one ulp apart).  The experts' matmuls accumulate in other
    orders in torch and XLA; the weighted combine sums each token's k
    slots left to right from zero, the reference's scatter-add order,
    and agrees bitwise where the expert outputs do (capacity 1);
  * gradients (f32, the reference's ``jax.grad`` of the same loss) —
    within 1e-4 of each leaf's largest magnitude, and a cosine of at
    least 0.99999.
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _compat import given, settings, st  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(e=8, k=2, shared=0, d=64, dff=64, mode="bf16"):
    kw = dict(name="t", family="decoder", num_layers=1, d_model=d,
              num_heads=2, num_kv_heads=2, head_dim=8, d_ff=32,
              vocab_size=64, num_experts=e, num_experts_per_tok=k,
              num_shared_experts=shared, moe_d_ff=dff, matmul_mode=mode)
    return JConfig(**kw), TConfig(**kw)


def _params(jcfg, seed=0):
    jp = init_tree(jmoe.moe_defs(jcfg), jax.random.key(seed))
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in jp.items()}
    return jp, tp


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def jroute(router, cfg, xt, capacity):
    """The reference's routing (``moe_apply``'s lines), jitted."""
    def fn(router, xt):
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        t = xt.shape[0]
        gates = jax.nn.softmax(
            jnp.einsum("td,de->te", xt.astype(jnp.float32),
                       router.astype(jnp.float32)), axis=-1)
        topw, topi = jax.lax.top_k(gates, k)
        topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
        me = gates.mean(0)
        ce = jnp.zeros((e,), jnp.float32).at[topi.reshape(-1)].add(1.0) / (
            t * k)
        aux = e * jnp.sum(me * ce)
        flat_e = topi.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        counts = jnp.bincount(sorted_e, length=e)
        seg_start = jnp.concatenate([jnp.array([0]),
                                     jnp.cumsum(counts)[:-1]])
        rank_sorted = jnp.arange(t * k) - seg_start[sorted_e]
        rank = jnp.zeros((t * k,), jnp.int32).at[order].set(
            rank_sorted.astype(jnp.int32))
        return {"topw": topw, "topi": topi, "rank": rank,
                "keep": rank < capacity, "counts": counts, "aux_loss": aux}
    return jax.jit(fn, compiler_options=EXACT)(router, xt)


def _assert_routing_equal(got, want):
    for key in ("topi", "rank", "keep", "counts"):
        np.testing.assert_array_equal(got[key].numpy(), np.array(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["topw"].detach().numpy(),
                               np.array(want["topw"]), rtol=2e-6, atol=0)
    np.testing.assert_array_max_ulp(got["aux_loss"].detach().numpy(),
                                    np.array(want["aux_loss"]), maxulp=2)


# ---------------------------------------------------------------------------
# moe_apply and its routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("ek", [(8, 2), (8, 8), (4, 1)],
                         ids=lambda ek: f"E{ek[0]}k{ek[1]}")
@pytest.mark.parametrize("capacity", [1, None, 64],
                         ids=["cap1", "capdefault", "cap64"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_apply_matches_reference(dtype, capacity, ek, shared, rng):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(*ek, shared=shared)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    want = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x, capacity),
                   compiler_options=EXACT)(jp, jx)
    got = tmoe.moe_apply(tp, tcfg, tx, capacity)
    assert got["out"].dtype == tdt and got["out"].shape == (2, 24, 64)

    cap = capacity or tmoe.moe_capacity(tcfg, 48)
    assert cap == (capacity or int(jcfg.capacity_factor * 48 * ek[1]
                                   / ek[0]) + 1)
    _assert_routing_equal(
        tmoe.route(tp["router"], tcfg, tx.reshape(48, 64), cap),
        jroute(jp["router"], jcfg, jx.reshape(48, 64), cap))
    np.testing.assert_array_max_ulp(got["aux_loss"].numpy(),
                                    np.array(want["aux_loss"]), maxulp=2)
    g, w = _f32(got["out"]), _f32(want["out"])
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    else:   # one bf16 ulp of the reference's value (8 bits of mantissa)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= ulp).all(), np.abs(g - w).max()


def test_moe_apply_capacity_one_is_bitwise(rng):
    """With one slot an expert, each kept output comes from a one-row
    product: the combine, the dropped slots and the output's cast agree
    with the reference bit for bit."""
    jcfg, tcfg = _cfgs(8, 2)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x, 1),
                   compiler_options=EXACT)(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    got = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x).bfloat16(), 1)
    np.testing.assert_array_equal(_f32(got["out"]), _f32(want["out"]))


@pytest.mark.parametrize("kind", ["zero_rows", "equal_columns"])
def test_router_ties_follow_top_k(kind, rng):
    """Equal gates: ``jax.lax.top_k`` puts the lower expert index first;
    the port's stable descending sort gives the same choice."""
    jcfg, tcfg = _cfgs(8, 3)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(40, 64)).astype(np.float32)
    router = np.array(jp["router"])
    if kind == "zero_rows":        # every logit 0: uniform gates
        x[::3] = 0.0
    else:                          # experts 1, 4 and 6 always tie
        router[:, 4] = router[:, 1]
        router[:, 6] = router[:, 1]
    cap = tmoe.moe_capacity(tcfg, 40)
    got = tmoe.route(torch.from_numpy(router), tcfg, torch.from_numpy(x),
                     cap)
    want = jroute(jnp.asarray(router), jcfg, jnp.asarray(x), cap)
    _assert_routing_equal(got, want)
    topi = got["topi"].numpy()
    if kind == "zero_rows":
        assert (topi[::3] == [0, 1, 2]).all()
    else:
        picked = np.isin(topi, [1, 4, 6])
        assert picked.any()
        for row, m in zip(topi, picked):     # tied experts in index order
            assert list(row[m]) == sorted(row[m])
    # and the whole layer on those inputs
    jp2 = dict(jp, router=jnp.asarray(router))
    tp2 = dict(tp, router=torch.from_numpy(router))
    want = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x),
                   compiler_options=EXACT)(jp2, jnp.asarray(x)[None])
    out = tmoe.moe_apply(tp2, tcfg, torch.from_numpy(x)[None])
    np.testing.assert_allclose(_f32(out["out"]), _f32(want["out"]),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("mode", ["bf16", "bp8_fused"])
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
def test_moe_grads_match_reference(shared, mode, rng):
    """Gradients of sum(out * c) + aux through router, experts and shared
    experts (in ``bp8_fused`` the shared experts' straight-through
    gradient), and of the input."""
    jcfg, tcfg = _cfgs(8, 2, shared=shared, mode=mode)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    c = rng.normal(size=(2, 16, 64)).astype(np.float32)

    def jloss(p, x):
        r = jmoe.moe_apply(p, jcfg, x)
        return jnp.sum(r["out"] * c) + r["aux_loss"]

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)), compiler_options=EXACT)(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), jnp.asarray(x))
    live = {k: v.float().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    r = tmoe.moe_apply(live, tcfg, tx)
    loss = (r["out"] * torch.from_numpy(c)).sum() + r["aux_loss"]
    names = sorted(live)
    grads = torch.autograd.grad(loss, [live[k] for k in names] + [tx])
    want = [jg[0][k] for k in names] + [jg[1]]
    assert set(names) >= {"router", "up", "gate", "down"}
    for name, g, w in zip(names + ["x"], grads, want):
        g, w = g.numpy(), np.array(w)
        big = np.abs(w).max()
        assert big > 0, name
        assert np.abs(g - w).max() <= 1e-4 * big, name
        cos = float(np.dot(g.ravel(), w.ravel())
                    / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert cos >= 0.99999, (name, cos)


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_moe.py), on the port
# ---------------------------------------------------------------------------

def _port(e=8, k=2, shared=0):
    jcfg, tcfg = _cfgs(e, k, shared=shared, d=16, dff=32)
    return tcfg, _params(jcfg)[1]


def test_moe_output_shape_and_aux(rng):
    cfg, params = _port()
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    out = tmoe.moe_apply(params, cfg, x)
    assert out["out"].shape == (2, 8, 16)
    assert bool(torch.isfinite(out["out"]).all())
    assert 0.0 < float(out["aux_loss"]) < float(cfg.num_experts)


def test_moe_capacity_drops_tokens(rng):
    cfg, params = _port()
    x = torch.from_numpy(rng.standard_normal((1, 32, 16)).astype(np.float32))
    full = tmoe.moe_apply(params, cfg, x, capacity=64)["out"]
    tiny = tmoe.moe_apply(params, cfg, x, capacity=1)["out"]
    assert float(tiny.abs().sum()) < float(full.abs().sum())


def test_moe_shared_experts_always_on(rng):
    cfg, params = _port(shared=1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    out0 = tmoe.moe_apply(params, cfg, x, capacity=1)["out"]
    assert float((out0.abs() > 0).float().mean()) > 0.9


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 16), st.integers(1, 4), st.integers(0, 2 ** 31 - 1))
def test_property_moe_finite(e, k, seed):
    k = min(k, e)
    jcfg, cfg = _cfgs(e, k, d=16, dff=32)
    params = _params(jcfg, seed % 100)[1]
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((1, 16, 16)).astype(np.float32))
    out = tmoe.moe_apply(params, cfg, x)
    assert bool(torch.isfinite(out["out"]).all())
    assert bool(torch.isfinite(out["aux_loss"]))


def test_moe_grads_flow_to_router(rng):
    cfg, params = _port()
    live = {k: v.float().requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    loss = (tmoe.moe_apply(live, cfg, x)["out"] ** 2).sum()
    g_router, g_up = torch.autograd.grad(loss, [live["router"], live["up"]])
    assert float(g_router.abs().sum()) > 0
    assert float(g_up.abs().sum()) > 0
