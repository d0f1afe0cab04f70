"""The port's kernels against the JAX reference, on the CPU.

Here every wrapper runs its plain PyTorch version (the tensors lie on the
CPU); the JAX side runs the Pallas kernels in interpret mode, as the
reference's own tests do.  Inputs come from numpy seeds.  Contract
(the reference's equivalence contract, carried over):

  * absmax and the fused matmul (real and int8-coded y) — bitwise;
  * the fused MLP — within 1e-5 (the integer accumulations are exact;
    only the activation's transcendental may differ in the last bits);
  * decode attention — within 1e-5 (the reference kernel reassociates the
    softmax across KV chunks).

The CUDA kernels themselves are held against the same plain versions on
the card by ``tests/test_torch_cuda.py`` (marked ``gpu``) and by
``chip_smoke.py``.
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import bp as jbp  # noqa: E402
from repro.core.quantize import quantize_bp as j_quantize_bp  # noqa: E402
from repro.kernels import attention as jattn  # noqa: E402
from repro.kernels import fused as jfused  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bp_matmul import _plane_thresholds  # noqa: E402
from repro_torch.core import bp as tbp  # noqa: E402
from repro_torch.core.quantize import quantize_bp  # noqa: E402
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import fused as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ODD_SHAPES = [(130, 100, 96), (16, 128, 128), (1, 7, 5), (129, 257, 130)]
# the decoder slice's dense shapes at the danube smoke width (d_model 64,
# q heads 64, kv heads 16, d_ff 160): decode with 2 slots, prefill chunk 8
PATH_SHAPES = [(2, 64, 64), (2, 64, 16), (2, 160, 64), (8, 64, 64),
               (8, 160, 64)]
TINY = float(np.finfo(np.float32).tiny)


def _real(rng, shape, scale=2.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np(x):
    return np.array(x)


# ---------------------------------------------------------------------------
# BP datasets, thresholds, LUT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["right", "left"])
def test_plane_thresholds_match_reference(which):
    assert tbp.plane_thresholds(which) == _plane_thresholds(which)
    want = {"right": (9, 8, 7, 4, 2, 1, 3, 5), "left": (5, 4, 1, 2, 3, 6, 8, 9)}
    assert tbp.plane_thresholds(which) == want[which]


def test_bitstreams_match_reference():
    right, left = jbp.bent_pyramid_datasets()
    np.testing.assert_array_equal(tbp.bitstreams("right"), right.bitstreams)
    np.testing.assert_array_equal(tbp.bitstreams("left"), left.bitstreams)
    np.testing.assert_array_equal(tbp.bitstreams_bp8("left"),
                                  left.bitstreams_bp8)


def test_mult_lut_matches_reference_and_masks():
    """The 10x10 product table equals the reference's, and equals the
    popcount of the per-level BP8 masks the CUDA kernels AND together."""
    lut = tbp.mult_lut()
    np.testing.assert_array_equal(lut, jbp.mult_lut())
    mr, ml = tbp.level_masks("right"), tbp.level_masks("left")
    pop = np.array([[bin(mr[a] & ml[b]).count("1") for b in range(10)]
                    for a in range(10)])
    np.testing.assert_array_equal(pop, lut)
    assert lut.max() == lut[9, 9] == 8
    packed = tbp.packed_thresholds("right")
    assert tuple((packed >> (4 * p)) & 0xF for p in range(8)) == \
        tbp.plane_thresholds("right")


@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_bp_bitwise(axis, rng):
    x = _real(rng, (33, 40))
    # values on the half-level boundaries of the per-tensor scale
    x[0, :20] = (np.arange(20) + 0.5) / 10.0 * np.abs(x).max()
    q = quantize_bp(torch.from_numpy(x), axis=axis)
    j = j_quantize_bp(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(q.levels.numpy(), _np(j.levels))
    np.testing.assert_array_equal(q.sign.numpy(), _np(j.sign))
    np.testing.assert_array_equal(q.scale.numpy(), _np(j.scale))
    np.testing.assert_array_equal(q.dequantize().numpy(),
                                  _np(j.dequantize()))


# ---------------------------------------------------------------------------
# absmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((384, 256), 128), ((8, 64), 8)])
def test_absmax_bitwise(shape, block, rng):
    x = _real(rng, shape)
    want = jfused.absmax_pallas(jnp.asarray(x), block_m=block,
                                block_n=block, interpret=True)
    got = tfused.absmax(torch.from_numpy(x))
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------------------
# NaN and Inf: the reference propagates NaN through every max (jnp.max,
# jnp.maximum) and the relu; the plain versions must give NaN where it does
# and its bits everywhere else
# ---------------------------------------------------------------------------

#: (name, value, flat indices it is written to)
SPECIALS = [("nan", np.nan, [5]), ("inf", np.inf, [3]),
            ("neg_inf", -np.inf, [7]), ("nan_and_inf", None, [5, 9])]


def _with_special(x, special):
    name, value, at = special
    x = x.copy()
    if value is None:                    # a NaN and an Inf in one input
        x.flat[at[0]], x.flat[at[1]] = np.nan, np.inf
    else:
        x.flat[at] = value
    return x


def assert_nan_and_bits_equal(got, want):
    """NaN exactly where the reference has NaN; every other value bitwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32))


@pytest.mark.parametrize("special", SPECIALS, ids=[s[0] for s in SPECIALS])
@pytest.mark.parametrize("shape", [(256, 256), (8, 64)])
def test_absmax_nan_and_inf_match_reference(shape, special, rng):
    x = _with_special(_real(rng, shape), special)
    want = jfused.absmax_pallas(jnp.asarray(x), block_m=8, block_n=64,
                                interpret=True)
    for floor in (0.0, TINY):
        got = tfused.absmax(torch.from_numpy(x), floor)
        assert_nan_and_bits_equal(
            got.numpy(), np.maximum(_np(want), np.float32(floor)))
    assert np.isnan(_np(want)).all() == (special[0] in ("nan", "nan_and_inf"))


@pytest.mark.parametrize("special", SPECIALS, ids=[s[0] for s in SPECIALS])
def test_fused_matmul_nan_and_inf_in_x_match_reference(special, rng):
    x = _with_special(_real(rng, (16, 128)), special)
    y = _real(rng, (128, 96))
    want = jops.oisma_matmul(jnp.asarray(x), jnp.asarray(y), interpret=True)
    got = tops.oisma_matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert_nan_and_bits_equal(got.numpy(), _np(want))
    assert np.isnan(_np(want)).all()     # a non-finite scale reaches all


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("special", SPECIALS, ids=[s[0] for s in SPECIALS])
def test_fused_mlp_nan_and_inf_in_x_match_reference(special, act, rng):
    x = _with_special(_real(rng, (16, 128)), special)
    up, gate = _real(rng, (128, 96)), _real(rng, (128, 96))
    want = jops.oisma_mlp(jnp.asarray(x), jnp.asarray(up), jnp.asarray(gate),
                          act=act, interpret=True)
    got = tops.oisma_mlp(torch.from_numpy(x), torch.from_numpy(up),
                         torch.from_numpy(gate), act=act)
    assert_nan_and_bits_equal(got.numpy(), _np(want))


def test_fused_mlp_relu_keeps_a_nan_in_w_gate(rng):
    x, up = _real(rng, (16, 128)), _real(rng, (128, 96))
    gate = _with_special(_real(rng, (128, 96)), SPECIALS[0])
    want = jops.oisma_mlp(jnp.asarray(x), jnp.asarray(up), jnp.asarray(gate),
                          act="relu", interpret=True)
    got = tops.oisma_mlp(torch.from_numpy(x), torch.from_numpy(up),
                         torch.from_numpy(gate), act="relu")
    assert_nan_and_bits_equal(got.numpy(), _np(want))
    assert np.isnan(_np(want)).all()


# ---------------------------------------------------------------------------
# fused matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coded", [False, True], ids=["real_y", "coded_y"])
@pytest.mark.parametrize("m,k,n", ODD_SHAPES + PATH_SHAPES)
def test_fused_matmul_bitwise(m, k, n, coded, rng):
    x, y = _real(rng, (m, k)), _real(rng, (k, n))
    if coded:
        jc, js = jops.prepare_bp_weight(jnp.asarray(y))
        tc, ts = tops.prepare_bp_weight(torch.from_numpy(y))
        np.testing.assert_array_equal(tc.numpy(), _np(jc))
        np.testing.assert_array_equal(ts.numpy(), _np(js))
        want = jops.oisma_matmul(jnp.asarray(x), jc, y_scale=js,
                                 interpret=True)
        got = tops.oisma_matmul(torch.from_numpy(x), tc, y_scale=ts)
    else:
        want = jops.oisma_matmul(jnp.asarray(x), jnp.asarray(y),
                                 interpret=True)
        got = tops.oisma_matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_fused_matmul_ref_matches_reference_oracle(rng):
    x, y = _real(rng, (40, 130)), _real(rng, (130, 24))
    np.testing.assert_array_equal(
        tref.fused_matmul_ref(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        _np(jref.fused_matmul_ref(jnp.asarray(x), jnp.asarray(y))))


def test_fused_matmul_errors(rng):
    x = torch.from_numpy(_real(rng, (8, 64)))
    with pytest.raises(ValueError, match="contraction"):
        tops.oisma_matmul(x, torch.zeros(100, 96))
    with pytest.raises(ValueError, match="y_scale"):
        tops.oisma_matmul(x, torch.zeros(64, 32, dtype=torch.int8))


# ---------------------------------------------------------------------------
# fused MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("m,k,f", [(130, 100, 96), (2, 64, 160)])
def test_fused_mlp_within_1e5(act, m, k, f, rng):
    x, up, gate = (_real(rng, (m, k)), _real(rng, (k, f)),
                   _real(rng, (k, f)))
    want = jops.oisma_mlp(jnp.asarray(x), jnp.asarray(up), jnp.asarray(gate),
                          act=act, interpret=True)
    got = tops.oisma_mlp(torch.from_numpy(x), torch.from_numpy(up),
                         torch.from_numpy(gate), act=act)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


def test_fused_mlp_ref_matches_reference_oracle(rng):
    x, up, gate = _real(rng, (9, 70)), _real(rng, (70, 33)), _real(rng, (70, 33))
    want = jref.fused_mlp_ref(jnp.asarray(x), jnp.asarray(up),
                              jnp.asarray(gate))
    got = tref.fused_mlp_ref(torch.from_numpy(x), torch.from_numpy(up),
                             torch.from_numpy(gate))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _attn_inputs(rng, b=3, s=64, kh=2, g=4, d=16, empty_tail=0,
                 dead_row=False):
    q = _real(rng, (b, kh, g, d), 1.0) / np.sqrt(d)
    kc, ks = jattn.quantize_kv(jnp.asarray(_real(rng, (b, s, kh, d), 1.0)))
    vc, vs = jattn.quantize_kv(jnp.asarray(_real(rng, (b, s, kh, d), 1.0)))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    qp = np.full((b,), s - 1, np.int32)
    if empty_tail:
        pos[0, s - empty_tail:] = -1
        qp[0] = s - empty_tail - 1
    if dead_row:
        pos[-1] = -1
    return [q, _np(kc), _np(ks), _np(vc), _np(vs), pos, qp]


def _attn_both(arrs, window, softcap, chunk):
    want = jattn.bp8_decode_attention(*map(jnp.asarray, arrs), window,
                                      softcap=softcap, chunk=chunk,
                                      interpret=True)
    got = tattn.bp8_decode_attention(*map(torch.from_numpy, arrs), window,
                                     softcap=softcap)
    return got.numpy(), _np(want)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, 17])
def test_decode_attention_within_1e5(window, softcap, rng):
    got, want = _attn_both(_attn_inputs(rng), window, softcap, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decode_attention_empty_tail_and_dead_row(rng):
    """An empty cache tail (pos -1) and a row whose kv_pos is all -1 (a
    padding row of the paged batch): the dead row averages V uniformly,
    as the reference's -1e30 sentinel makes it."""
    arrs = _attn_inputs(rng, empty_tail=20, dead_row=True)
    got, want = _attn_both(arrs, 17, None, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    v = tattn.dequantize_kv(torch.from_numpy(arrs[3]),
                            torch.from_numpy(arrs[4])).numpy()
    uniform = v[-1].mean(axis=0)                          # (KH, D)
    np.testing.assert_allclose(got[-1], np.repeat(uniform[:, None], 4, 1),
                               rtol=0, atol=1e-5)


def test_decode_attention_odd_chunks(rng):
    """S=48 under a requested chunk of 13: the reference picks chunk 6."""
    got, want = _attn_both(_attn_inputs(rng, s=48), 17, None, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decode_attention_nan_in_q_matches_reference(rng):
    """A NaN in one query head: NaN in that head's output, as in the
    reference; every other value within 1e-5."""
    arrs = _attn_inputs(rng)
    arrs[0][1, 0, 2, 3] = np.nan
    got, want = _attn_both(arrs, None, None, 16)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1, 0, 2]).all() and np.isnan(want).sum() == 16
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors run the plain versions and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_plain_versions_and_count_no_launch(rng):
    tbuild.reset_launches()
    x, y = torch.from_numpy(_real(rng, (4, 32))), torch.from_numpy(
        _real(rng, (32, 8)))
    tops.oisma_matmul(x, y)
    tops.oisma_mlp(x, y, y)
    tattn.bp8_decode_attention(*map(torch.from_numpy, _attn_inputs(rng)), 8)
    assert sum(tbuild.LAUNCHES.values()) == 0


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="devices"):
        tfused.absmax(x)
    with pytest.raises(ValueError, match="devices"):
        tfused.fused_bp_matmul(x, torch.empty((8, 4)), torch.ones(1, 1),
                               torch.ones(1, 1))
