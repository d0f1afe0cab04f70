"""The port's multi-head latent attention, and the MoE/MLA archs' param
trees, against the JAX reference, on the CPU.

``mla_apply`` runs each branch on the same inputs as the reference's
(jitted with ``xla_allow_excess_precision`` off): training (no cache),
prefill into an empty latent cache, chunked append over it, then
absorbed single-token decode over several steps.  Parameters come from
the reference's ``init_tree`` and cross through numpy.

Tolerances:
  * ``bp8_fused`` and ``bp8`` — the latent caches and the outputs
    bitwise: the BP projections are exact integer sums, and the f32
    einsums and softmax round to the same bf16 output;
  * ``bf16`` — the outputs within 2**-6 relative plus 1e-3 absolute
    (observed <= 3.9e-3 on one element, >= 99.8% bitwise) and the latent
    caches within one bf16 ulp: the bf16 projections accumulate in
    another order;
  * the training path (no cache) in ``bp8_fused`` — within one bf16 ulp
    (2**-8 relative plus 1e-6).
The absorbed decode and the expanded prefill are different float
orders in the reference too, so the port's decode is held to the
reference's decode and its prefill to the reference's prefill.
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro.optim.optimizer import OptimizerConfig as JOpt  # noqa: E402
from repro.train.train_step import init_state as jinit_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.params import init_params, tree_leaves  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
MLA_ARCHS = ["deepseek_v2_236b", "minicpm3_4b"]
NEW_ARCHS = ["granite_moe_1b", "deepseek_v2_236b", "minicpm3_4b"]
#: (rtol, atol) of the outputs by mode, 0 = bitwise (docstring)
TOL = {"bp8_fused": (0, 0), "bp8": (0, 0), "bf16": (2 ** -6, 1e-3)}


def to_np(tree):
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def configs(arch, mode, **kw):
    return (dataclasses.replace(jget_config(arch, smoke=True),
                                matmul_mode=mode, **kw),
            dataclasses.replace(get_config(arch, smoke=True),
                                matmul_mode=mode, **kw))


def _layer_params(jcfg, seed=1):
    jp = init_tree(jattn.mla_defs(jcfg), jax.random.key(seed))
    tp = {k: torch.from_numpy(v).to(torch.float32 if "norm" in k
                                    else torch.bfloat16)
          for k, v in to_np(jp).items()}
    return jp, tp


# ---------------------------------------------------------------------------
# mla_apply, branch by branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [
    pytest.param(a, m, id=f"{a}-{m}") for a, m in (
        ("deepseek_v2_236b", "bp8_fused"), ("deepseek_v2_236b", "bf16"),
        ("minicpm3_4b", "bp8_fused"), ("minicpm3_4b", "bf16"),
        ("minicpm3_4b", "bp8"), ("no_q_lora", "bp8_fused"))])
def test_mla_apply_cache_branches(arch, mode, rng):
    """Prefill (12 tokens), a chunked append (4), then 4 absorbed decode
    steps, each against the reference's call on the same inputs and the
    reference's cache; rows decode at their own positions."""
    if arch == "no_q_lora":        # q straight from x through ``wq``
        jcfg, tcfg = configs("minicpm3_4b", mode, q_lora_rank=0)
    else:
        jcfg, tcfg = configs(arch, mode)
    jp, tp = _layer_params(jcfg)
    assert ("wq" in tp) == (arch == "no_q_lora")
    rtol, atol = TOL[mode]
    b, n, d = 2, 32, jcfg.d_model
    jcache = jattn.init_cache(jattn.kv_cache_spec(jcfg, b, n))
    tcache = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        tattn.kv_cache_spec(tcfg, b, n)[k][1]) for k, v in jcache.items()}

    def run(x, pos, append):
        nonlocal jcache
        fn = jax.jit(lambda p, x, pos, c: jattn.mla_apply(
            p, jcfg, x, pos, cache=c, append=append), compiler_options=EXACT)
        jo, jcache = fn(jp, jnp.asarray(x).astype(jnp.bfloat16),
                        jnp.asarray(pos), jcache)
        to, _ = tattn.mla_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(pos), cache=tcache,
                                append=append)
        assert to.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(to), f32(jo), rtol=rtol, atol=atol)
        for k in jcache:
            if mode == "bf16" and k != "pos":
                np.testing.assert_allclose(f32(tcache[k]), f32(jcache[k]),
                                           rtol=2 ** -8, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(f32(tcache[k]),
                                              f32(jcache[k]), err_msg=k)

    x = rng.normal(size=(b, 12, d)).astype(np.float32)
    run(x, np.tile(np.arange(12, dtype=np.int32), (b, 1)), False)  # prefill
    x = rng.normal(size=(b, 4, d)).astype(np.float32)
    run(x, np.tile(np.arange(12, 16, dtype=np.int32), (b, 1)), True)  # append
    for step in range(4):                                          # decode
        x = rng.normal(size=(b, 1, d)).astype(np.float32)
        run(x, np.array([[16 + step], [20 + step]], np.int32), False)


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_apply_training_path(arch, rng):
    """No cache: K/V expanded from the f32 latents, causal over the
    sequence: 64 tokens take the chunked online softmax (two chunks of
    32), 70 the direct path, by the reference's rule."""
    for s in (64, 70):
        jcfg, tcfg = configs(arch, "bp8_fused")
        jp, tp = _layer_params(jcfg, seed=2)
        x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
        jo, _ = jax.jit(lambda p, x, pos: jattn.mla_apply(p, jcfg, x, pos),
                        compiler_options=EXACT)(
            jp, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos))
        to, cache = tattn.mla_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(pos))
        assert cache is None
        np.testing.assert_allclose(f32(to), f32(jo), rtol=2 ** -8, atol=1e-6)


def test_mla_cache_spec_axes_and_bp8_refusal():
    for arch in MLA_ARCHS:
        cfg = get_config(arch, smoke=True)
        spec = tattn.kv_cache_spec(cfg, 3, 16)
        want = jattn.kv_cache_spec(jget_config(arch, smoke=True), 3, 16)
        assert sorted(spec) == sorted(want) == ["ckv", "krope", "pos"]
        for k, (shape, dtype) in spec.items():
            assert shape == want[k].shape, k
            assert str(dtype).split(".")[-1] == str(want[k].dtype), k
        axes = tattn.kv_cache_axes(cfg)
        assert axes == jattn.kv_cache_axes(jget_config(arch, smoke=True))
        assert all(a[1:3] == ("batch", "kv_seq") for a in axes.values())
        bad = dataclasses.replace(cfg, kv_quant="bp8")
        msg = "the MLA latent cache is already compressed"
        for fn in (tattn.kv_quantized,
                   lambda c: tattn.kv_cache_spec(c, 1, 8),
                   tattn.kv_cache_axes):
            with pytest.raises(ValueError, match=msg):
                fn(bad)
        with pytest.raises(ValueError, match=msg):
            build(bad)


# ---------------------------------------------------------------------------
# the new archs' param trees: schema, converters, init rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_schema_and_converters_take_the_reference_trees(arch):
    """The reference's params and train state convert leaf for leaf
    (router f32, the (E, d, f) experts, the shared experts, the 3-D
    ``wuk``/``wuv``, ``dense_layers``) and back, bitwise."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jm = jbuild(jcfg)
    jstate = jinit_state(jm, jax.random.key(0), JOpt())
    jstate["opt"]["m"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.25),
                                      jstate["params"])
    jstate["opt"]["step"] = jnp.int32(5)
    want = to_np(jstate)
    state = train_state_from_numpy(want, tcfg, "cpu")
    params = state["params"]
    jleaves = {tuple(k.key for k in path): leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jstate["params"])[0]}
    tleaves = dict(tree_leaves(params))
    assert sorted(jleaves) == sorted(tleaves)
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(jleaves[path].dtype), \
            path
    assert int(state["opt"]["step"]) == 5
    back = train_state_to_numpy(state)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b).reshape(np.shape(a)), a,
                                      err_msg=str(path))
    if tcfg.num_experts:
        moe = params["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff
        n = tcfg.num_layers - tcfg.first_dense_layers
        assert moe["up"].shape == (n, e, d, f)
        assert moe["down"].shape == (n, e, f, d)
        assert ("shared_up" in moe) == bool(tcfg.num_shared_experts)
    if tcfg.first_dense_layers:
        assert params["dense_layers"]["mlp"]["up"].shape[0] == \
            tcfg.first_dense_layers
    if tcfg.attention_type == "mla":
        wuk = params["layers"]["attn"]["wuk"]
        assert wuk.shape[1:] == (tcfg.kv_lora_rank, tcfg.num_heads,
                                 tcfg.qk_nope_head_dim)
    # the converted params serve: the port's prefill runs on them
    logits, _ = build(tcfg).prefill(
        params_from_numpy(want["params"], tcfg, "cpu"),
        {"tokens": torch.arange(2, 10)[None]}, 16)
    assert logits.shape == (1, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_follows_the_reference_std_rule(arch):
    """Each leaf's seeded draw has the reference's std (normal leaves:
    scale / sqrt(fan_in), fan_in the second-to-last dim, also for the
    (E, d, f) experts and the (R, H, D) up-projections; embed 1; norms
    0): the sample stds agree within 10%."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = to_np(init_tree(jbuild(jcfg).schema(), jax.random.key(0)))
    tp = init_params(build(tcfg).schema(), seed=0, device="cpu")
    jleaves = {tuple(k.key for k in path): leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, leaf in tree_leaves(tp):
        want = float(np.std(jleaves[path]))
        got = float(leaf.float().std(unbiased=False))
        if want == 0.0:
            assert got == 0.0, path
        else:
            assert abs(got / want - 1.0) < 0.1, (path, got, want)
