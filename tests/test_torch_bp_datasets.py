"""The port's BP datasets, their design-time search and the stochastic
reference of the in-array multiply, against the reference's
``repro.core.bp`` on the CPU.

Datasets, the search's placements, levels, bitstreams and AND/popcount
products are held equal; the float64 matmul references bitwise (every
sum is an integer below 2^53, so the port's one-matmul contraction and
the reference's einsum cannot part).
"""
import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

from repro.core import bp as jbp  # noqa: E402
from repro_torch.core import bp as tbp  # noqa: E402

SHAPES = [(5, 70, 9), (1, 7, 5), (33, 128, 16)]


def _t(a):
    return torch.as_tensor(np.asarray(a), device="cpu")


def _equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pairs():
    return zip(tbp.bent_pyramid_datasets(), jbp.bent_pyramid_datasets())


def test_canonical_datasets_equal_the_reference():
    right, left = tbp.bent_pyramid_datasets()
    assert right.starts == tbp.RIGHT_STARTS and left.starts == tbp.LEFT_STARTS
    for got, want in _pairs():
        assert (got.name, got.starts, got.lengths) == (
            want.name, want.starts, want.lengths)
        np.testing.assert_array_equal(got.bitstreams, want.bitstreams)
        np.testing.assert_array_equal(got.bitstreams_bp8, want.bitstreams_bp8)
        for bits in (tbp.BITS, tbp.EFFECTIVE_BITS):
            np.testing.assert_array_equal(got.words(bits), want.words(bits))
    # the kernels' tables read the same source
    np.testing.assert_array_equal(tbp.bitstreams("right"), right.bitstreams)
    np.testing.assert_array_equal(tbp.bitstreams_bp8("left"),
                                  left.bitstreams_bp8)
    np.testing.assert_array_equal(tbp.mult_lut(), jbp.mult_lut())
    np.testing.assert_array_equal(tbp.mult_lut(right, left),
                                  jbp.mult_lut(*jbp.bent_pyramid_datasets()))


def test_bp8_identity_for_every_level_pair():
    right, left = tbp.bent_pyramid_datasets()
    x, y = np.meshgrid(np.arange(10), np.arange(10), indexing="ij")
    p10 = tbp.sc_multiply(_t(x), _t(y), bits=tbp.BITS)
    p8 = tbp.sc_multiply(_t(x), _t(y), bits=tbp.EFFECTIVE_BITS)
    _equal(p10, tbp.mult_lut(right, left))
    _equal(p8, tbp.mult_lut(right, left))
    _equal(p8, jbp.sc_multiply(x, y, bits=8))


def _weight():
    rng = np.random.default_rng(7)
    w = rng.uniform(0.1, 3.0, (10, 10))
    w[3, 6] = 20.0                     # the paper's 0.3 x 0.6 example
    return w


@pytest.mark.parametrize("kw", [
    dict(pins_right={3: 5}, pins_left={6: 1}, iters=5),
    dict(pins_right={3: 5}, pins_left={6: 1}),
    dict(weight=_weight(), iters=8),
    dict(weight=_weight(), pins_right={3: 5}, pins_left={6: 1},
         seed_datasets="shifted"),
], ids=["paper_pins_5_iters", "paper_pins", "weighted", "weighted_seeded"])
def test_optimize_datasets_equal_the_reference(kw):
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("seed_datasets") == "shifted":
        starts_r = (0, 7, 6, 5, 5, 4, 3, 3, 2, 1)
        starts_l = (0, 2, 2, 3, 3, 2, 1, 1, 0, 0)
        tkw["seed_datasets"] = (tbp._blocks_to_dataset("r", starts_r),
                                tbp._blocks_to_dataset("l", starts_l))
        jkw["seed_datasets"] = (jbp._blocks_to_dataset("r", starts_r),
                                jbp._blocks_to_dataset("l", starts_l))
    got = tbp.optimize_datasets(**tkw)
    want = jbp.optimize_datasets(**jkw)
    for g, w in zip(got, want):
        assert (g.name, g.starts) == (w.name, w.starts)
        np.testing.assert_array_equal(g.bitstreams, w.bitstreams)
    if "pins_right" in kw:
        assert got[0].starts[3] == 5 and got[1].starts[6] == 1


def test_dataset_refuses_a_block_past_the_word():
    with pytest.raises(ValueError, match="level 9"):
        tbp._blocks_to_dataset("bad", (0, 0, 0, 0, 0, 0, 0, 0, 0, 2))


def _boundary_inputs(dtype):
    """Every level boundary k/10 and (k+0.5)/10 and one ulp on either side
    of each, values below 0 and above 0.95, in ``dtype``."""
    centres = np.concatenate([np.arange(11) / 10.0,
                              (np.arange(11) + 0.5) / 10.0]).astype(dtype)
    near = [centres, np.nextafter(centres, dtype(np.inf)),
            np.nextafter(centres, dtype(-np.inf))]
    extra = np.array([-1.0, -0.05, -1e-30, 0.949, 0.95, 0.951, 0.96, 1.0,
                      1.5, 7.0, 1e30], dtype=dtype)
    return np.concatenate(near + [extra])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_to_levels_at_the_boundaries(dtype):
    x = _boundary_inputs(dtype)
    _equal(tbp.quantize_to_levels(_t(x)), jbp.quantize_to_levels(x))
    # the reference's own case
    x = np.array([0.0, 0.04, 0.051, 0.54, 0.949, 0.951, 1.0])
    assert tbp.quantize_to_levels(_t(x)).tolist() == [0, 0, 1, 5, 9, 9, 9]


def test_quantize_integer_input_and_levels_to_prob():
    x = np.array([-3, 0, 1, 2], dtype=np.int64)
    _equal(tbp.quantize_to_levels(_t(x)), jbp.quantize_to_levels(x))
    lv = np.arange(10, dtype=np.int32)
    _equal(tbp.levels_to_prob(_t(lv)), jbp.levels_to_prob(lv))


@pytest.mark.parametrize("bits", [10, 8])
def test_encode_and_sc_multiply_equal_the_reference(bits):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 10, (6, 1, 5)).astype(np.int32)
    y = rng.integers(0, 10, (1, 4, 5)).astype(np.int32)
    for (tds, jds), lv in zip(_pairs(), (x, y)):
        _equal(tbp.encode(_t(lv), tds, bits), jbp.encode(lv, jds, bits))
    _equal(tbp.sc_multiply(_t(x), _t(y), bits=bits),
           jbp.sc_multiply(x, y, bits=bits))
    # through explicit datasets, and a search's datasets
    t_opt = tbp.optimize_datasets(pins_right={3: 5}, pins_left={6: 1})
    j_opt = jbp.optimize_datasets(pins_right={3: 5}, pins_left={6: 1})
    _equal(tbp.sc_multiply(_t(x), _t(y), *t_opt, bits=bits),
           jbp.sc_multiply(x, y, *j_opt, bits=bits))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 1.5)],
                         ids=["inside", "outside"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bp_matmul_references_bitwise(shape, lo, hi, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.uniform(lo, hi, (m, k)).astype(dtype)
    y = rng.uniform(lo, hi, (k, n)).astype(dtype)
    want = jbp.bp_matmul_reference(x, y)
    got = tbp.bp_matmul_reference(_t(x), _t(y))
    _equal(got, want)
    for bits in (10, 8):
        _equal(tbp.bp_matmul_bitplane(_t(x), _t(y), bits=bits),
               jbp.bp_matmul_bitplane(x, y, bits=bits))
    _equal(tbp.bp_matmul_bitplane(_t(x), _t(y)), want)
    # against the searched datasets too
    t_opt = tbp.optimize_datasets(weight=_weight(), iters=8)
    j_opt = jbp.optimize_datasets(weight=_weight(), iters=8)
    _equal(tbp.bp_matmul_reference(_t(x), _t(y), *t_opt),
           jbp.bp_matmul_reference(x, y, *j_opt))
