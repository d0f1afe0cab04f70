"""The port's unfused OISMA pipeline against the JAX reference, on the CPU.

Here every wrapper runs its plain PyTorch version (the tensors lie on the
CPU); the JAX side runs its Pallas kernels in interpret mode, as the
reference's own tests do.  Inputs come from numpy seeds.  Everything on
the pipeline is integer or a single IEEE expression, so the contract is
bitwise throughout:

  * the codes matmul against ``bp_matmul_pallas`` and ``bp_matmul_codes``;
  * the popcount periphery against ``ops.popcount_accumulate`` (exact);
  * the BP quantise against ``ref.bp_quantize_ref`` (also at half-level
    boundaries), against ``quantize_bp``'s codes, and against
    ``bp_quantize_pallas`` where its ``|x| * (10 / s)`` agrees with
    ``|x| / s * 10``; a bf16 input is quantised by its f32 value, as the
    Pallas kernel casts its tile;
  * ``oisma_matmul(impl="unfused")`` against the reference's unfused
    pipeline and against the port's fused path, with f32 weights and with
    bf16 weights read as stored (the reference jitted with
    ``xla_allow_excess_precision`` off, as the other parity tests run it).

The CUDA kernels are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` (marked ``gpu``) and ``chip_smoke.py``.
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.quantize import quantize_bp as j_quantize_bp  # noqa: E402
from repro.kernels import bp_matmul as jk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.quantize import quantize_bp  # noqa: E402
from repro_torch.kernels import bp_matmul as tk  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ODD_SHAPES = [(130, 100, 96), (16, 128, 128), (1, 7, 5), (129, 257, 130)]
# the decoder slice's dense shapes at the danube smoke width (see
# test_torch_kernels.py)
PATH_SHAPES = [(2, 64, 64), (2, 64, 16), (2, 160, 64), (8, 64, 64),
               (8, 160, 64)]


def _codes(rng, shape):
    return rng.integers(-9, 10, shape, dtype=np.int8)


def _real(rng, shape, scale=2.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _half_level_inputs(x, s):
    """x with its first values replaced by the half-level boundaries
    (l + 0.5) * s / 10 of scale s and their f32 neighbours, both signs."""
    mid = (np.arange(9, dtype=np.float32) + np.float32(0.5)) * s / np.float32(10)
    vals = np.concatenate([mid, np.nextafter(mid, np.float32(np.inf)),
                           np.nextafter(mid, np.float32(-np.inf))])
    vals = np.concatenate([vals, -vals]).astype(np.float32)
    flat = x.reshape(-1).copy()
    flat[:vals.size] = vals
    return flat.reshape(x.shape)


# ---------------------------------------------------------------------------
# codes matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 128),
                                   (128, 256, 384), (8, 128, 128)])
def test_codes_matmul_matches_pallas_kernel(m, k, n, rng):
    x, y = _codes(rng, (m, k)), _codes(rng, (k, n))
    want = jk.bp_matmul_pallas(jnp.asarray(x), jnp.asarray(y),
                               block_m=min(128, m), block_n=128, block_k=128,
                               interpret=True)
    got = tk.bp_matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("m,k,n", [(100, 300, 130), (1, 7, 5)])
def test_codes_matmul_matches_padded_ops(m, k, n, rng):
    x, y = _codes(rng, (m, k)), _codes(rng, (k, n))
    want = jops.bp_matmul_codes(jnp.asarray(x), jnp.asarray(y),
                                interpret=True)
    got = tops.bp_matmul_codes(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    np.testing.assert_array_equal(
        got.numpy(), np.array(jref.bp_matmul_ref(jnp.asarray(x),
                                                 jnp.asarray(y))))


def test_codes_matmul_extremes(rng):
    """All-9 codes give the largest sums (8 per k): still exact."""
    x = np.full((3, 1000), 9, np.int8)
    y = np.full((1000, 4), -9, np.int8)
    got = tk.bp_matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert (got.numpy() == -8000.0).all()


# ---------------------------------------------------------------------------
# popcount periphery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,c", [(256, 256), (512, 64), (300, 100)])
def test_popcount_matches_reference(r, c, rng):
    bits = (rng.random((r, c)) < 0.5).astype(np.int8)
    want = jops.popcount_accumulate(jnp.asarray(bits), interpret=True)
    got = tops.popcount_accumulate(torch.from_numpy(bits))
    assert got.dtype == torch.int32 and got.shape == (r,)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.bool])
def test_popcount_any_byte_values(dtype, rng):
    """The sum of the values, not a count of set bits: any int8 row."""
    raw = rng.integers(-128, 128, (37, 300)).astype(np.int8)
    bits = torch.from_numpy(raw)
    if dtype is torch.uint8:
        bits = bits.to(torch.uint8)
    elif dtype is torch.bool:
        bits = bits > 0
    want = bits.numpy().astype(np.int64).sum(-1)
    np.testing.assert_array_equal(tops.popcount_accumulate(bits).numpy(),
                                  want)


def test_periphery_sums_to_the_codes_matmul(rng):
    """The hardware story of the codes matmul: the AND of each pair's BP8
    words, signed, laid out as one row per output; the row popcounts are
    the product."""
    m, k, n = 4, 50, 6
    xc, yc = _codes(rng, (m, k)), _codes(rng, (k, n))
    xb = np.array(jref._tables()[0])[np.abs(xc)]          # (M, K, 8)
    yb = np.array(jref._tables()[1])[np.abs(yc)]          # (K, N, 8)
    sign = np.sign(xc)[:, :, None] * np.sign(yc)[None]    # (M, K, N)
    bits = (xb[:, :, None, :] * yb[None]) * sign[..., None]
    rows = bits.transpose(0, 2, 1, 3).reshape(m * n, k * 8).astype(np.int8)
    got = tops.popcount_accumulate(torch.from_numpy(rows)).reshape(m, n)
    want = tops.bp_matmul_codes(torch.from_numpy(xc), torch.from_numpy(yc))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# BP quantise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", [False, True], ids=["random", "halves"])
@pytest.mark.parametrize("shape", [(256, 256), (33, 70), (61,)])
def test_bp_quantize_matches_reference_oracle(shape, boundary, rng):
    x = _real(rng, shape, 3.0)
    s = np.float32(np.abs(x).max())
    if boundary:
        x = _half_level_inputs(x, s)
    want = jref.bp_quantize_ref(jnp.asarray(x), jnp.float32(s))
    got = tk.bp_quantize(torch.from_numpy(x), torch.tensor([[s]]))
    assert got.dtype == torch.int8 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("boundary", [False, True], ids=["random", "halves"])
def test_bp_quantize_equals_quantize_bp_codes(boundary, rng):
    x = _real(rng, (64, 96))
    if boundary:
        x = _half_level_inputs(x, np.float32(np.abs(x).max()))
    q, jq = quantize_bp(torch.from_numpy(x)), j_quantize_bp(jnp.asarray(x))
    got = tk.bp_quantize(torch.from_numpy(x), q.scale)
    np.testing.assert_array_equal(got.numpy(), tref.to_codes(q).numpy())
    np.testing.assert_array_equal(got.numpy(), np.array(jops.to_codes(jq)))


@pytest.mark.parametrize("m,c", [(256, 256), (512, 512), (256, 768)])
def test_bp_quantize_matches_pallas_kernel(m, c, rng):
    """Random inputs, as the reference's own kernel test draws them: away
    from the half-level boundaries, where the kernel's |x| * (10 / s)
    parts from |x| / s * 10."""
    x = (rng.standard_normal((m, c)) * 3).astype(np.float32)
    s = np.float32(np.abs(x).max())
    want = jk.bp_quantize_pallas(jnp.asarray(x), jnp.float32(s),
                                 interpret=True)
    got = tk.bp_quantize(torch.from_numpy(x), torch.tensor([[s]]))
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_bp_quantize_half_level_expression(rng):
    """Next to the half-level boundaries the two expressions split; the
    port follows ``|x| / s * 10``, as ``quantize_bp`` does."""
    s = (rng.random((64, 1)) * 10 + 0.5).astype(np.float32)
    ten = np.float32(10)
    mid = (np.arange(9, dtype=np.float32) + np.float32(0.5)) * s / ten
    x = np.concatenate([mid, np.nextafter(mid, np.float32(np.inf)),
                        np.nextafter(mid, np.float32(-np.inf))], axis=1)
    div = np.clip(np.rint(x / s * ten), 0, 9)
    mul = np.clip(np.rint(x * (ten / s)), 0, 9)
    assert (div != mul).any()
    for i in range(len(s)):
        got = tk.bp_quantize(torch.from_numpy(x[i]), torch.from_numpy(s[i]))
        np.testing.assert_array_equal(got.numpy(), div[i].astype(np.int8))


def _bf16_half_level_inputs(x, s):
    """bf16 x with its first values replaced by the bf16 values next to the
    half-level boundaries (l + 0.5) * s / 10 of scale s: the nearest bf16
    and the bf16 patterns one above and one below it, both signs."""
    mid = torch.from_numpy((np.arange(9, dtype=np.float32) + np.float32(0.5))
                           * s / np.float32(10)).to(torch.bfloat16)
    bits = mid.view(torch.int16)
    vals = torch.cat([bits, bits + 1, bits - 1]).view(torch.bfloat16)
    vals = torch.cat([vals, -vals])
    flat = x.reshape(-1).clone()
    flat[:vals.numel()] = vals
    return flat.reshape(x.shape)


@pytest.mark.parametrize("boundary", [False, True], ids=["random", "halves"])
@pytest.mark.parametrize("shape", [(256, 256), (33, 70), (61,)])
def test_bp_quantize_bf16_input_is_its_f32_value(shape, boundary, rng):
    """A bf16 x is quantised by the f32 value of each element: the codes
    equal those of its f32 cast bitwise (the plain version once divided
    in bf16: 261 of 65536 codes apart at 256 x 256, seed 0)."""
    x = torch.from_numpy(_real(rng, shape, 1.0)).to(torch.bfloat16)
    s = tref.tensor_scale(x.float())
    if boundary:
        x = _bf16_half_level_inputs(x, np.float32(s.item()))
    got = tk.bp_quantize(x, s)
    assert got.dtype == torch.int8 and got.shape == shape
    want = tref.bp_quantize_ref(x.float(), s)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), tk.bp_quantize(x.float(),
                                                              s).numpy())


@pytest.mark.parametrize("m,c", [(256, 256), (512, 512), (256, 768)])
def test_bp_quantize_bf16_matches_pallas_kernel(m, c, rng):
    """bf16 inputs drawn as the reference's own kernel test draws its f32
    ones; the Pallas kernel casts its bf16 tile to f32."""
    xj = jnp.asarray(rng.standard_normal((m, c)) * 3, jnp.float32).astype(
        jnp.bfloat16)
    s = jnp.abs(xj).max()
    want = jk.bp_quantize_pallas(xj, s, interpret=True)
    x = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tk.bp_quantize(x, torch.tensor([[float(s)]]))
    np.testing.assert_array_equal(got.numpy(), np.array(want))


# ---------------------------------------------------------------------------
# oisma_matmul(impl="unfused")
# ---------------------------------------------------------------------------

EXACT = {"xla_allow_excess_precision": False}

@pytest.mark.parametrize("m,k,n", ODD_SHAPES + PATH_SHAPES)
def test_unfused_matmul_bitwise(m, k, n, rng):
    x, y = _real(rng, (m, k)), _real(rng, (k, n))
    want = jops.oisma_matmul(jnp.asarray(x), jnp.asarray(y), impl="unfused",
                             interpret=True)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tops.oisma_matmul(tx, ty, impl="unfused")
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    np.testing.assert_array_equal(got.numpy(),
                                  tops.oisma_matmul(tx, ty).numpy())


@pytest.mark.parametrize("m,k,n", ODD_SHAPES + PATH_SHAPES)
def test_unfused_matmul_bf16_weight_bitwise(m, k, n, rng):
    """A bf16 weight reaches the quantise as stored: bitwise the reference
    given the same bf16 weight, the port's fused path, and the unfused
    path on the f32 cast."""
    x = _real(rng, (m, k))
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    wt, wj = torch.from_numpy(w).to(torch.bfloat16), \
        jnp.asarray(w).astype(jnp.bfloat16)
    ref_unfused = jax.jit(lambda a, b: jops.oisma_matmul(
        a, b, impl="unfused", interpret=True), compiler_options=EXACT)
    tx = torch.from_numpy(x)
    got = tops.oisma_matmul(tx, wt, impl="unfused")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_unfused(jnp.asarray(x), wj)))
    np.testing.assert_array_equal(got.numpy(), tops.oisma_matmul(tx,
                                                                 wt).numpy())
    np.testing.assert_array_equal(
        got.numpy(), tops.oisma_matmul(tx, wt.float(), impl="unfused").numpy())


def test_unfused_matmul_errors(rng):
    x = torch.from_numpy(_real(rng, (8, 64)))
    codes, scale = tops.prepare_bp_weight(torch.from_numpy(_real(rng, (64, 8))))
    with pytest.raises(ValueError, match="real weights"):
        tops.oisma_matmul(x, codes, y_scale=scale, impl="unfused")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.oisma_matmul(x, torch.zeros(64, 8), impl="pallas")
    with pytest.raises(ValueError, match="contraction"):
        tops.oisma_matmul(x, torch.zeros(100, 8), impl="unfused")
    with pytest.raises(ValueError, match="contraction"):
        tops.bp_matmul_codes(codes, codes)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors run the plain versions and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_tensors_launch_nothing(rng):
    tbuild.reset_launches()
    x, y = torch.from_numpy(_real(rng, (4, 32))), torch.from_numpy(
        _real(rng, (32, 8)))
    tops.oisma_matmul(x, y, impl="unfused")
    tops.popcount_accumulate(torch.ones((3, 5), dtype=torch.int8))
    assert sum(tbuild.LAUNCHES.values()) == 0


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="devices"):
        tk.bp_matmul(x, torch.empty((8, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="devices"):
        tk.bp_quantize(torch.empty((4, 8), device="meta"), torch.ones(1, 1))
    with pytest.raises(ValueError, match="devices"):
        tk.popcount_accumulate(x)
