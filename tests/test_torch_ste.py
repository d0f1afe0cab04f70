"""The straight-through BP ops against the JAX reference, on the CPU, and
the comparison form of the bitplane encode.

``oisma_matmul_ste`` and ``oisma_mlp_ste`` run the fused ops forward and
the gradients of the plain f32 matmul / gated MLP backward.  Inputs come
from numpy seeds; the reference runs its Pallas kernels in interpret
mode under ``jax.grad``, compiled with ``xla_allow_excess_precision``
off.  Weights are f32 or bf16; the reference casts a bf16 weight to f32
before the op (``layers.dense``), the port hands it to the op as stored.

Tolerances:
  * the matmul's forward bitwise; the MLP's forward bitwise the port's
    own ``oisma_mlp`` and within 1e-5 of the reference's for silu and
    gelu (the activation's transcendental differs in the last bits, as
    in ``test_torch_bf16_weights.py``), bitwise for relu;
  * f32 gradients within 1e-6 of the largest magnitude of the
    reference's gradient (the f32 products sum in another order);
  * bf16 gradients (weights held as bf16) within one bf16 ulp of the
    reference's an element, or 1e-6 of the largest magnitude: a
    last-bit difference of the f32 gradient can round the bf16 cast the
    other way;
  * every gradient in its input's dtype.
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import bp_matmul as tbpm  # noqa: E402
from repro_torch.kernels import metrics  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
WDTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


def _weight(rng, shape, wdt):
    """The same weight for both packages (bf16 rounds to nearest even on
    each side), and its f32 values."""
    w = (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
    tdt, jdt = WDTYPES[wdt]
    wj = jnp.asarray(w).astype(jdt)
    return torch.from_numpy(w).to(tdt), wj


def _close_grad(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    d = np.abs(g - want)
    lim = 1e-6 * np.abs(want).max()
    if got.dtype == torch.bfloat16:    # one bf16 ulp of each element
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        lim = np.maximum(lim, ulp)
    assert (d <= lim).all(), (what, float(d.max()), float(np.max(lim)))


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(24, 100, 96), (7, 64, 160)])
def test_matmul_ste_forward_bitwise_and_grads(m, k, n, wdt, rng):
    x = (rng.normal(size=(m, k)) * 2.0).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    wt, wj = _weight(rng, (k, n), wdt)

    def jfn(a, b):
        return jops.oisma_matmul_ste(a, b.astype(jnp.float32),
                                     interpret=True)

    want = jax.jit(jfn, compiler_options=EXACT)(jnp.asarray(x), wj)
    jgx, jgw = jax.jit(jax.grad(lambda a, b: jnp.sum(jfn(a, b) * g),
                                argnums=(0, 1)),
                       compiler_options=EXACT)(jnp.asarray(x), wj)
    tx = torch.from_numpy(x).requires_grad_()
    tw = wt.clone().requires_grad_()
    out = tops.oisma_matmul_ste(tx, tw)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    (out * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == wt.dtype
    _close_grad(tx.grad, jgx, "x")
    _close_grad(tw.grad, jgw, "w")


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_ste_forward_and_grads(act, wdt, rng):
    m, k, f = 24, 100, 96
    x = (rng.normal(size=(m, k)) * 2.0).astype(np.float32)
    g = rng.normal(size=(m, f)).astype(np.float32)
    (ut, uj), (gt, gj) = _weight(rng, (k, f), wdt), _weight(rng, (k, f), wdt)

    def jfn(a, u, w):
        return jops.oisma_mlp_ste(a, u.astype(jnp.float32),
                                  w.astype(jnp.float32), act=act,
                                  interpret=True)

    want = jax.jit(jfn, compiler_options=EXACT)(jnp.asarray(x), uj, gj)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                              argnums=(0, 1, 2)),
                     compiler_options=EXACT)(jnp.asarray(x), uj, gj)
    ts = [torch.from_numpy(x).requires_grad_(), ut.clone().requires_grad_(),
          gt.clone().requires_grad_()]
    out = tops.oisma_mlp_ste(*ts, act=act)
    with torch.no_grad():
        assert torch.equal(out, tops.oisma_mlp(*ts, act=act))
    if act == "relu":
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    for t, jg, what in zip(ts, jgrads, ("x", "w_up", "w_gate")):
        assert t.grad.dtype == t.dtype, what
        _close_grad(t.grad, jg, what)


def test_only_requested_grads_are_computed(rng):
    """A frozen weight gets no gradient and the input's still flows."""
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    xr = x.clone().requires_grad_()
    tops.oisma_matmul_ste(xr, w).sum().backward()
    assert xr.grad is not None and w.grad is None
    torch.testing.assert_close(xr.grad, torch.ones(4, 16) @ w.T, rtol=0,
                               atol=0)


def test_served_path_records_nothing_and_counts_as_before(rng):
    """Under inference mode the STE routing gives bitwise the ops' results,
    builds no graph, and counts one ``kernels.calls`` a call, as the
    direct calls did."""
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)).to(
        torch.bfloat16)
    p = {k: torch.from_numpy(rng.normal(size=(64, 160)).astype(np.float32)
                             ).to(torch.bfloat16) for k in ("up", "gate")}
    p["down"] = torch.from_numpy(rng.normal(size=(160, 64)).astype(
        np.float32)).to(torch.bfloat16)
    reg = MetricsRegistry()
    prev = metrics.set_registry(reg)
    try:
        with torch.inference_mode():
            y = tlayers.dense(x.bfloat16(), w, "bp8_fused")
            h = tlayers.mlp_apply(p, x.bfloat16(), "silu", True, "bp8_fused")
        assert y.grad_fn is None and h.grad_fn is None
        assert reg.value("kernels.calls", kernel="fused_matmul") == 2
        assert reg.value("kernels.calls", kernel="fused_mlp") == 1
        want = tops.oisma_matmul(x.bfloat16().reshape(-1, 64).float(), w)
        assert torch.equal(y, want.reshape(3, 5, 16).bfloat16())
    finally:
        metrics.set_registry(prev)


def _gather_planes(levels, which, dtype):
    """The earlier form: a gather from the dataset's (10, 8) table."""
    return tbpm._table(which, dtype, levels.device)[levels.long()]


@pytest.mark.parametrize("which", ["right", "left"])
@pytest.mark.parametrize("ldtype", [torch.int8, torch.int32, torch.int64])
def test_comparison_encode_equals_table_for_every_level(which, ldtype):
    levels = torch.arange(10, dtype=ldtype).reshape(2, 5)
    for dtype in (torch.float32, torch.bfloat16):
        got = tbpm.encode_bitplanes(levels, which, dtype)
        assert got.dtype == dtype and got.shape == (2, 5, 8)
        assert torch.equal(got, _gather_planes(levels, which, dtype))
