"""The port's BP matmul family and quantisers against the JAX reference,
on the CPU.  Inputs come from numpy seeds.  The reference is compiled
(``jit`` with ``xla_allow_excess_precision`` off, as in
``test_torch_model.py``): compiled, it scales the BP matmuls as
``c * ((sx * sy) * 0.1)``, not as its source's ``(c / 10) * (sx * sy)``
(ROADMAP Queue 3), and the port follows the compiled form.

Tolerances:
  * ``lut_factors``, the tables, ``encode_bitplanes``, ``quantize_e4m3``,
    ``quantize_bp_levels``, ``bp_dequantize`` and the fake quantisers'
    forward — bitwise;
  * ``bp_matmul`` lut and bitplane (and their level-domain forms) —
    bitwise: every product is an integer below 2**24, exact in any
    summation order, and the rescale is the same two f32 operations;
  * ``bp_matmul`` lowrank — 1e-5 relative to the output's largest value:
    the factors are not integers, so the matmul's summation order shows;
  * straight-through gradients — 1e-6 relative (plain f32 matmuls summed
    in another order).
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bp_matmul as jbpm  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro_torch.core import bp_matmul as tbpm  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(5, 70, 9), (1, 7, 5), (33, 128, 16)]
EXACT = {"xla_allow_excess_precision": False}


def jjit(fn, **kw):
    """The reference, compiled to round where its code casts."""
    return jax.jit(fn, compiler_options=EXACT, **kw)


def _real(rng, shape, scale=2.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _levels(rng, shape):
    return rng.integers(0, 10, shape).astype(np.int32)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# tables and factors
# ---------------------------------------------------------------------------

def test_tables_and_lut_factors_equal():
    for a, b in zip(tbpm._tables(), jbpm._tables()):
        np.testing.assert_array_equal(a, b)
    for rank in (None, 3):
        tl, tr, trk = tbpm.lut_factors(rank=rank)
        jl, jr, jrk = jbpm.lut_factors(rank=rank)
        assert trk == jrk
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
    assert tbpm.lut_rank() == jbpm.lut_rank() == 8


@pytest.mark.parametrize("which", ["right", "left"])
def test_encode_bitplanes_bitwise(which, rng):
    lv = _levels(rng, (6, 11))
    got = tbpm.encode_bitplanes(torch.from_numpy(lv), which, torch.float32)
    want = jbpm.encode_bitplanes(jnp.asarray(lv), which, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


# ---------------------------------------------------------------------------
# level-domain matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", SHAPES)
def test_level_matmuls_match_reference(m, k, n, rng):
    xl, yl = _levels(rng, (m, k)), _levels(rng, (k, n))
    tx, ty, jx, jy = (torch.from_numpy(xl), torch.from_numpy(yl),
                      jnp.asarray(xl), jnp.asarray(yl))
    lut = tbpm.bp_matmul_lut(tx, ty).numpy()
    np.testing.assert_array_equal(
        lut, np.array(jjit(jbpm.bp_matmul_lut)(jx, jy)))
    np.testing.assert_array_equal(
        tbpm.bp_matmul_bitplane(tx, ty).numpy(),
        np.array(jjit(jbpm.bp_matmul_bitplane)(jx, jy)))
    np.testing.assert_array_equal(tbpm.bp_matmul_bitplane(tx, ty).numpy(),
                                  lut)
    low = tbpm.bp_matmul_lowrank(tx, ty).numpy()
    assert _rel(low, np.array(jjit(jbpm.bp_matmul_lowrank)(jx, jy))) <= 1e-5
    assert _rel(low, lut) <= 1e-5


def test_lowrank_truncated_rank(rng):
    xl, yl = _levels(rng, (8, 40)), _levels(rng, (40, 8))
    got = tbpm.bp_matmul_lowrank(torch.from_numpy(xl), torch.from_numpy(yl),
                                 rank=3).numpy()
    want = np.array(jjit(lambda a, b: jbpm.bp_matmul_lowrank(a, b, rank=3))(
        jnp.asarray(xl), jnp.asarray(yl)))
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# signed, scaled bp_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["lut", "bitplane", "lowrank"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bp_matmul_matches_reference(m, k, n, impl, rng):
    x, y = _real(rng, (m, k)), _real(rng, (k, n))
    x[0, 0] = 0.0
    got = tbpm.bp_matmul(torch.from_numpy(x), torch.from_numpy(y),
                         impl=impl).numpy()
    want = np.array(jjit(lambda a, b: jbpm.bp_matmul(a, b, impl=impl))(
        jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == (m, n) and got.dtype == np.float32
    if impl == "lowrank":
        assert _rel(got, want) <= 1e-5
    else:
        np.testing.assert_array_equal(got, want)
        # the compiled scaling is the fused kernel's epilogue: same bits
        np.testing.assert_array_equal(got, tops.oisma_matmul(
            torch.from_numpy(x), torch.from_numpy(y)).numpy())


def test_bp_matmul_unknown_impl():
    with pytest.raises(ValueError, match="unknown impl"):
        tbpm.bp_matmul(torch.ones(2, 3), torch.ones(3, 2), impl="mxu")


@pytest.mark.parametrize("impl", ["bitplane", "lowrank"])
def test_bp_matmul_ste_gradients(impl, rng):
    x, y, g = _real(rng, (6, 40)), _real(rng, (40, 12)), _real(rng, (6, 12))

    def jloss(x, y):
        return jnp.sum(jbpm.bp_matmul_ste(x, y, impl=impl) * jnp.asarray(g))

    jgx, jgy = jjit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                                     jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    (tbpm.bp_matmul_ste(tx, ty, impl=impl) * torch.from_numpy(g)).sum().backward()
    assert _rel(tx.grad.numpy(), np.array(jgx)) <= 1e-6
    assert _rel(ty.grad.numpy(), np.array(jgy)) <= 1e-6


# ---------------------------------------------------------------------------
# quantisers
# ---------------------------------------------------------------------------

def test_e4m3_values_equal():
    for mv in (448.0, 240.0):
        np.testing.assert_array_equal(tq.e4m3_positive_values(mv),
                                      jq.e4m3_positive_values(mv))
    assert tq.e4m3_positive_values().size == 126


def test_quantize_e4m3_bitwise(rng):
    grid = np.concatenate([[0.0], jq.e4m3_positive_values()])
    mids = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    x = np.concatenate([
        _real(rng, (500,), 50.0), _real(rng, (200,), 0.01),
        mids, np.nextafter(mids, np.float32(np.inf)), -mids,
        np.array([0.0, 447.9, 448.0, 460.0, 1e6, -1e6], np.float32)])
    x = x.astype(np.float32)
    got = tq.quantize_e4m3(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.array(jq.quantize_e4m3(
        jnp.asarray(x))))
    got = tq.quantize_e4m3(torch.from_numpy(x), 240.0).numpy()
    np.testing.assert_array_equal(got, np.array(jq.quantize_e4m3(
        jnp.asarray(x), 240.0)))


def test_bp_levels_and_dequantize_bitwise(rng):
    x01 = rng.random(300).astype(np.float32)
    x01[:20] = (np.arange(20) + 0.5) / 20
    lv = tq.quantize_bp_levels(torch.from_numpy(x01))
    jlv = jq.quantize_bp_levels(jnp.asarray(x01))
    assert lv.dtype == torch.int32
    np.testing.assert_array_equal(lv.numpy(), np.array(jlv))
    np.testing.assert_array_equal(tq.bp_dequantize(lv).numpy(),
                                  np.array(jq.bp_dequantize(jlv)))


@pytest.mark.parametrize("kind", ["bp", "bp_axis", "e4m3"])
def test_fake_quantize_forward_and_ste_gradient(kind, rng):
    x, g = _real(rng, (9, 30), 3.0), _real(rng, (9, 30))
    fns = {"bp": (lambda v: tq.fake_quantize_bp(v),
                  lambda v: jq.fake_quantize_bp(v)),
           "bp_axis": (lambda v: tq.fake_quantize_bp(v, axis=-1),
                       lambda v: jq.fake_quantize_bp(v, axis=-1)),
           "e4m3": (tq.fake_quantize_e4m3, jq.fake_quantize_e4m3)}
    tfn, jfn = fns[kind]
    tx = torch.from_numpy(x).requires_grad_()
    out = tfn(tx)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.array(jfn(jnp.asarray(x))))
    (out * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jfn(v) * jnp.asarray(g)))(jnp.asarray(x))
    assert _rel(tx.grad.numpy(), np.array(jg)) <= 1e-6
    np.testing.assert_array_equal(tx.grad.numpy(), g)
