"""Mamba2 (SSD) against the JAX reference, on the CPU.

``mamba2_apply`` of the zamba2 smoke config (matmul mode bf16, so the
block's own arithmetic is what is compared) runs a fresh prefill of 32
tokens in two SSD chunks of 16, a chunk continuation of 8 tokens from
the state, a one-token chunk (the recurrent branch) and a decode step,
in f32 and in bf16 activations, with and without ``ssm_decay_bf16``;
every leaf of the block is random (the init's zero leaves would hide
``a_log``, ``dt_bias``, ``conv_b`` and the norm).  The reference is
compiled with ``xla_allow_excess_precision`` off.

Tolerances, relative to the largest magnitude of the compared value
(observed in brackets): the SSD's contractions (C B^T, the states, the
recurrence's ``C h``) sum in another order than XLA's dot_general, and
the port's ``exp``/``log1p`` may differ from XLA's in the last bit, so y
and both states agree to f32 rounding: ``REL`` 2e-6 [8.4e-7]; with
``ssm_decay_bf16`` the decay matrix and the diagonal blocks' operands
round to bf16, where a one-ulp f32 difference can flip a bf16 value:
``REL_DECAY`` 1e-3 on the f32 y [3.2e-4]; bf16 outputs within one bf16
ulp [3.1e-6].  The port alone, a chunked and recurrent run against a
one-shot run in f32: ``REL`` on y and both states [4.0e-7].
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

from test_torch_model import f32, jjit  # noqa: E402

REL = 2e-6
REL_DECAY = 1e-3


def configs(decay_bf16=False):
    kw = dict(matmul_mode="bf16", ssm_decay_bf16=decay_bf16)
    return (dataclasses.replace(jget_config("zamba2_2p7b", smoke=True), **kw),
            dataclasses.replace(get_config("zamba2_2p7b", smoke=True), **kw))


@pytest.fixture(scope="module")
def block():
    """One Mamba2 block's random parameters: (reference, port)."""
    jcfg, tcfg = configs()
    rng = np.random.default_rng(4)
    jp, tp = {}, {}
    tdefs = tssm.mamba2_defs(tcfg)
    for k, d in jssm.mamba2_defs(jcfg).items():
        std = 0.1 if d.init in ("zeros", "ones") else 1 / np.sqrt(
            d.shape[-2] if len(d.shape) > 1 else 1)
        a = (rng.normal(size=d.shape) * std
             + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)
        jp[k] = jnp.asarray(a).astype(d.dtype)
        tp[k] = torch.from_numpy(f32(jp[k])).to(tdefs[k].dtype)
    return jp, tp


def _close(got, want, rel):
    want, got = f32(want), f32(got)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_defs_and_state_spec_match_reference():
    jcfg, tcfg = configs()
    for k, d in jssm.mamba2_defs(jcfg).items():
        t = tssm.mamba2_defs(tcfg)[k]
        assert (t.shape, t.axes, t.init) == (d.shape, d.axes, d.init), k
        assert str(t.dtype).split(".")[-1] == str(np.dtype(d.dtype)), k
    for batch in (1, 3):
        want = jssm.mamba2_state_spec(jcfg, batch)
        got = tssm.mamba2_state_spec(tcfg, batch)
        assert {k: s for k, (s, _) in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(d == torch.float32 for _, d in got.values())
    full_j, full_t = jget_config("zamba2_2p7b"), get_config("zamba2_2p7b")
    assert tssm.mamba2_dims(full_t) == jssm.mamba2_dims(full_j) == (
        5120, 80, 64)


def test_segsum_matches_reference(rng):
    a = rng.normal(size=(2, 3, 16)).astype(np.float32)
    want = f32(jjit(jssm._segsum)(a))
    got = f32(tssm._segsum(torch.from_numpy(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], REL)


@pytest.mark.parametrize("decay_bf16", [False, True],
                         ids=["decay_f32", "decay_bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_matches_reference(block, dtype, decay_bf16, rng):
    """No state (training), fresh prefill (two SSD chunks), a chunk
    continuation, a one-token chunk and a decode step: y and both
    states."""
    jcfg, tcfg = configs(decay_bf16)
    jp, tp = block
    b, d = 2, jcfg.d_model
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rel = REL_DECAY if decay_bf16 and dtype == "float32" else REL
    fn = jjit(lambda p, x, s: jssm.mamba2_apply(p, jcfg, x, state=s,
                                                chunk=16))

    def run(x, state):
        jy, js = fn(jp, jnp.asarray(x).astype(jdt), state[0])
        ty, ts = tssm.mamba2_apply(tp, tcfg, torch.from_numpy(x).to(tdt),
                                   state=state[1], chunk=16)
        assert ty.dtype == tdt
        if dtype == "bfloat16":
            _close(ty, jy, 2 ** -8)
        else:
            _close(ty, jy, rel)
        if js is not None:
            for k in js:
                assert ts[k].dtype == torch.float32
                _close(ts[k], js[k], REL)
        return js, ts

    x = rng.normal(size=(b, 32, d)).astype(np.float32)
    assert run(x, (None, None)) == (None, None)
    spec = tssm.mamba2_state_spec(tcfg, b)
    state = ({k: jnp.zeros(s, jnp.float32) for k, (s, _) in spec.items()},
             {k: torch.zeros(s) for k, (s, _) in spec.items()})
    state = run(x, state)                              # fresh prefill
    for n in (8, 1, 1):              # continuation, one-token chunk, decode
        x = rng.normal(size=(b, n, d)).astype(np.float32)
        state = run(x, state)


def test_chunked_continuation_equals_one_shot(block, rng):
    """The port alone, f32: 40 tokens at once against 16 + 8 + 8 tokens
    (the SSD continuing from the state) and 8 one-token steps (the
    recurrence): y and the final states."""
    _, tcfg = configs()
    _, tp = block
    x = torch.from_numpy(rng.normal(size=(2, 40, tcfg.d_model)).astype(
        np.float32))
    spec = tssm.mamba2_state_spec(tcfg, 2)

    def fresh():
        return {k: torch.zeros(s) for k, (s, _) in spec.items()}

    whole, ws = tssm.mamba2_apply(tp, tcfg, x, state=fresh(), chunk=8)
    state, parts, p = fresh(), [], 0
    for n in (16, 8, 8) + (1,) * 8:
        y, state = tssm.mamba2_apply(tp, tcfg, x[:, p:p + n], state=state,
                                     chunk=8)
        parts.append(y)
        p += n
    _close(torch.cat(parts, dim=1), whole, REL)
    for k in ws:
        _close(state[k], ws[k], REL)


@pytest.mark.parametrize("s,chunk", [(300, 256), (48, 32)])
def test_ssd_refuses_lengths_the_reference_refuses(s, chunk, rng):
    """``_ssd_chunked`` needs S to be a multiple of min(chunk, S): the
    reference asserts it, the port raises ValueError on the same
    inputs."""
    h, p, n = 2, 4, 3
    x = rng.normal(size=(1, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(1, s, h))).astype(np.float32)
    a = -np.ones(h, np.float32)
    bc = rng.normal(size=(1, s, n)).astype(np.float32)
    with pytest.raises(AssertionError):
        jssm._ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                          jnp.asarray(bc), jnp.asarray(bc), chunk)
    t = [torch.from_numpy(v) for v in (x, dt, a, bc, bc)]
    with pytest.raises(ValueError, match="not a multiple of its chunk"):
        tssm._ssd_chunked(*t, chunk)
    ok = s - s % min(chunk, s)                 # the same call, cut to fit
    y, h_fin = tssm._ssd_chunked(*(v[:, :ok] if v.dim() > 1 else v
                                   for v in t), chunk)
    assert y.shape == (1, ok, h, p) and h_fin.shape == (1, h, p, n)

