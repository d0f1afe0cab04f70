"""The port's counter-based sampling against ``jax.random``, on the CPU.

* the threefry words of ``key(seed)`` and both ``fold_in``s, the 32-bit
  random bits (in the layout the installed jax uses, and in the other
  one, asked for by argument), and the uniforms: bitwise, over seeds 0-3,
  rids 0-5, steps 0-7 and vocabularies 1, 7, 256 and 32000;
* the gumbel noise within 2 ulp, the ulp taken at ``max(|g|, 1)``: the
  scale the noise is added to the logits at.  ``log`` may differ in its
  last bit between torch and XLA, and near ``g = 0`` the outer log turns
  that bit of the inner one into a large relative error of a tiny value;
* ``sample_row`` and ``sample_tokens`` give the reference's tokens at T in
  {0.5, 0.8, 1.0, 2.0}; dead rows draw nothing; T 0 is the argmax.
"""
import contextlib

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import sampling as jsamp  # noqa: E402
from repro_torch.serve import sampling as tsamp  # noqa: E402

SEEDS = range(4)
ROWS = [(rid, step) for rid in range(6) for step in range(8)]
VOCABS = [1, 7, 256, 32000]
TEMPERATURES = [0.5, 0.8, 1.0, 2.0]
TINY = float(np.finfo(np.float32).tiny)


@contextlib.contextmanager
def threefry_layout(partitionable: bool):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def jax_keys(seed):
    rid = jnp.array([r for r, _ in ROWS], jnp.uint32)
    step = jnp.array([s for _, s in ROWS], jnp.uint32)
    return jax.vmap(lambda r, s: jax.random.fold_in(
        jax.random.fold_in(jax.random.key(seed), r), s))(rid, step)


def as_u32(a):
    return np.asarray(a).astype(np.int64)


def test_gumbel_mode_is_low():
    """The port implements jax's ``mode="low"`` gumbel, the default while
    ``jax_high_dynamic_range_gumbel`` is off."""
    assert not jax.config.jax_high_dynamic_range_gumbel


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_match(seed):
    k0 = jax.random.key_data(jax.random.key(seed))
    np.testing.assert_array_equal(tsamp.seed_key(seed)[0].numpy(), as_u32(k0))
    want = as_u32(jax.vmap(jax.random.key_data)(jax_keys(seed)))
    np.testing.assert_array_equal(tsamp.row_keys(seed, ROWS, "cpu").numpy(),
                                  want)
    # one fold_in alone, at the edges of the 32-bit range
    data = [0, 1, 2**31, 2**32 - 1]
    key = tsamp.seed_key(seed, len(data))
    got = tsamp.fold_in(key, torch.tensor(data, dtype=torch.int64)).numpy()
    for row, d in zip(got, data):
        np.testing.assert_array_equal(row, as_u32(jax.random.key_data(
            jax.random.fold_in(jax.random.key(seed), d))))


def test_seed_and_data_out_of_range_raise():
    with pytest.raises(ValueError, match="seed"):
        tsamp.seed_key(2**32)
    with pytest.raises(ValueError, match="rid"):
        tsamp.row_keys(0, [(-1, 0)], "cpu")


@pytest.mark.parametrize("layout", ["installed", "other"])
@pytest.mark.parametrize("vocab", VOCABS)
def test_bits_uniform_gumbel_match(layout, vocab):
    installed = bool(jax.config.jax_threefry_partitionable)
    partitionable = installed if layout == "installed" else not installed
    ulps = 0.0
    with threefry_layout(partitionable):
        for seed in SEEDS:
            keys = jax_keys(seed)
            jbits = jax.vmap(lambda k: jax.random.bits(
                k, (vocab,), jnp.uint32))(keys)
            juni = jax.vmap(lambda k: jax.random.uniform(
                k, (vocab,), jnp.float32, minval=TINY, maxval=1.0))(keys)
            jgum = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
                k, (vocab,), jnp.float32))(keys))
            tkeys = tsamp.row_keys(seed, ROWS, "cpu")
            bits = tsamp.random_bits(tkeys, vocab, partitionable)
            np.testing.assert_array_equal(bits.numpy(), as_u32(jbits))
            uni = tsamp.uniform(bits)
            np.testing.assert_array_equal(uni.numpy().view(np.int32),
                                          np.asarray(juni).view(np.int32))
            gum = tsamp.gumbel(uni).numpy()
            scale = np.spacing(np.maximum(np.abs(jgum), np.float32(1)))
            ulps = max(ulps, float((np.abs(gum.astype(np.float64) - jgum)
                                    / scale).max()))
    assert ulps <= 2.0, ulps


@pytest.mark.parametrize("vocab", [256, 32000])
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_sample_tokens_match(vocab, temperature):
    partitionable = bool(jax.config.jax_threefry_partitionable)
    rng = np.random.default_rng(vocab)
    seeds = SEEDS if vocab <= 256 else [0]
    for seed in seeds:
        logits = (rng.normal(size=(len(ROWS), vocab)) * 3).astype(np.float32)
        want = jsamp.sample_tokens(jnp.asarray(logits), ROWS, seed=seed,
                                   temperature=temperature)
        got = tsamp.sample_tokens(torch.from_numpy(logits), ROWS, seed=seed,
                                  temperature=temperature,
                                  partitionable=partitionable)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        for i in (0, 13, 47):
            rid, step = ROWS[i]
            assert tsamp.sample_row(
                torch.from_numpy(logits[i]), seed=seed, rid=rid, step=step,
                temperature=temperature, partitionable=partitionable) \
                == jsamp.sample_row(logits[i], seed=seed, rid=rid, step=step,
                                    temperature=temperature)


def test_dead_rows_draw_nothing():
    """A dead row gets the argmax, and the live rows' tokens are those they
    draw alone: dead rows consume and perturb no randomness."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32))
    rows = [(3, 1), None, (0, 4), None, (7, 0)]
    got = tsamp.sample_tokens(logits, rows, seed=2, temperature=0.8)
    want = jsamp.sample_tokens(jnp.asarray(logits.numpy()), rows, seed=2,
                               temperature=0.8)
    np.testing.assert_array_equal(got, want)
    for i, row in enumerate(rows):
        if row is None:
            assert got[i] == int(torch.argmax(logits[i]))
        else:
            assert got[i] == tsamp.sample_row(
                logits[i], seed=2, rid=row[0], step=row[1], temperature=0.8)
    none = tsamp.sample_tokens(logits, [None] * 5, seed=2, temperature=0.8)
    np.testing.assert_array_equal(none, torch.argmax(logits, -1).numpy())


def test_temperature_zero_is_argmax():
    logits = np.zeros((3, 16), np.float32)
    logits[0, [2, 9]] = 1.0               # a tie: the first maximum
    logits[1, 15] = 5.0
    logits[2, 0] = -1.0
    rows = [(0, 0), (1, 0), None]
    got = tsamp.sample_tokens(torch.from_numpy(logits), rows, seed=0,
                              temperature=0.0)
    np.testing.assert_array_equal(got, [2, 15, 1])
    np.testing.assert_array_equal(
        got, jsamp.sample_tokens(jnp.asarray(logits), rows, seed=0,
                                 temperature=0.0))
    assert tsamp.sample_row(torch.from_numpy(logits[0]), seed=0, rid=0,
                            step=0, temperature=-1.0) == 2
