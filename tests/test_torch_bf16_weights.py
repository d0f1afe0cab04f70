"""bf16 weights read as stored, against the JAX reference, on the CPU.

The model holds its weights in bf16.  The port's absmax, fused matmul and
fused MLP take them as they are (the CUDA kernels widen bf16 to f32 in
registers; the plain versions here cast inside), as the Pallas kernels
cast their tiles in the kernel body.  Widening bf16 to f32 is exact, so
the results equal both the JAX reference given the same bf16 weights and
the port's own call on the f32 cast.  Inputs come from numpy seeds; the
JAX side runs the Pallas kernels in interpret mode.

Tolerances: absmax and the matmul bitwise; the MLP within 1e-5 for silu
and gelu (the activation's transcendental may differ in the last bits)
and bitwise for relu; against the port's own f32-cast call, bitwise.
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused as jfused  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import fused as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)
# ragged shapes and the smoke decoder's (d_model 64, kv width 16, d_ff 160)
SHAPES = [(130, 100, 96), (1, 7, 5), (2, 64, 160), (8, 64, 16),
          (8, 160, 64)]


def _pair(rng, shape, scale=1.0):
    """A bf16 weight made from seeded f32 values, for both packages: the
    same bits on each side (both round to nearest even)."""
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    np.testing.assert_array_equal(wt.float().numpy(),
                                  np.asarray(wj.astype(jnp.float32)))
    return wt, wj


def _x(rng, shape):
    return (rng.normal(size=shape) * 2.0).astype(np.float32)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_weight_matmul_bitwise(m, k, n, rng):
    x = _x(rng, (m, k))
    wt, wj = _pair(rng, (k, n), k ** -0.5)
    am = tfused.absmax(wt)
    assert am.dtype == torch.float32 and am.shape == (1, 1)
    np.testing.assert_array_equal(
        am.numpy(), np.asarray(jfused.absmax_pallas(wj, interpret=True)))
    got = tops.oisma_matmul(torch.from_numpy(x), wt)
    want = jops.oisma_matmul(jnp.asarray(x), wj, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tops.oisma_matmul(torch.from_numpy(x),
                                              wt.float()))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("m,k,f", [(130, 100, 96), (2, 64, 160), (1, 7, 5)])
def test_bf16_weight_mlp(act, m, k, f, rng):
    x = _x(rng, (m, k))
    (ut, uj), (gt, gj) = (_pair(rng, (k, f), k ** -0.5) for _ in range(2))
    got = tops.oisma_mlp(torch.from_numpy(x), ut, gt, act=act)
    want = np.asarray(jops.oisma_mlp(jnp.asarray(x), uj, gj, act=act,
                                     interpret=True))
    if act == "relu":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got, tops.oisma_mlp(torch.from_numpy(x), ut.float(),
                                           gt.float(), act=act))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absmax_floor_of_zeros(dtype):
    z = np.zeros((8, 16), np.float32)
    want = jnp.maximum(jfused.absmax_pallas(
        jnp.asarray(z).astype(dtype), interpret=True), TINY)
    got = tfused.absmax(torch.from_numpy(z).to(getattr(torch, dtype)),
                        floor=TINY)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.item() == TINY
    assert tfused.absmax(torch.from_numpy(z)).item() == 0.0


@pytest.mark.parametrize("floor", [0.0, TINY, 0.5, 100.0])
def test_absmax_floor_is_a_max(floor, rng):
    x = torch.from_numpy(_x(rng, (33, 17)))
    for t in (x, x.to(torch.bfloat16)):
        want = torch.clamp_min(tref.absmax_ref(t), floor)
        assert torch.equal(tfused.absmax(t, floor=floor), want)
    assert torch.equal(tops._scale(x), tref.tensor_scale(x))


def _recording(monkeypatch):
    """Patch the three kernel wrappers to record the dtypes they get."""
    seen = {"absmax": [], "fused_bp_matmul": [], "fused_mlp": []}
    for name in seen:
        real = getattr(tfused, name)

        def rec(*args, _real=real, _name=name, **kw):
            seen[_name].append(tuple(a.dtype for a in args
                                     if isinstance(a, torch.Tensor)))
            return _real(*args, **kw)

        monkeypatch.setattr(tfused, name, rec)
    return seen


def test_served_layers_pass_bf16_weights(monkeypatch, rng):
    """``dense`` and ``mlp_apply`` in ``bp8_fused`` hand the bf16 weights
    to the kernels' wrappers as they are held: no f32 cast on the way,
    and the result is the f32-cast call's."""
    x = torch.from_numpy(_x(rng, (2, 3, 64))).to(torch.bfloat16)
    w, _ = _pair(rng, (64, 48), 0.125)
    p = {"up": _pair(rng, (64, 160), 0.125)[0],
         "gate": _pair(rng, (64, 160), 0.125)[0],
         "down": _pair(rng, (160, 64), 0.08)[0]}
    want_dense = tlayers.dense(x, w.float(), "bp8_fused")
    want_mlp = tlayers.mlp_apply({k: v.float() for k, v in p.items()}, x,
                                 "silu", True, "bp8_fused")
    seen = _recording(monkeypatch)
    got_dense = tlayers.dense(x, w, "bp8_fused")
    assert seen["fused_bp_matmul"] == [(torch.float32, torch.bfloat16,
                                        torch.float32, torch.float32)]
    assert (torch.bfloat16,) in seen["absmax"]
    for v in seen.values():
        v.clear()
    got_mlp = tlayers.mlp_apply(p, x, "silu", True, "bp8_fused")
    assert seen["fused_mlp"] == [(torch.float32, torch.bfloat16,
                                  torch.bfloat16) + (torch.float32,) * 3]
    # the down projection's weight reaches the matmul as bf16 too
    assert seen["fused_bp_matmul"][0][1] == torch.bfloat16
    assert seen["absmax"].count((torch.bfloat16,)) == 3
    assert torch.equal(got_dense, want_dense)
    assert torch.equal(got_mlp, want_mlp)
