"""The training loss and its gradients against the JAX reference, on the CPU.

Parameters come from the reference's ``init_tree`` and cross through
numpy (``params_from_numpy``); batches from the data pipeline.  The
reference is ``jax.value_and_grad(model.loss)``, compiled with
``xla_allow_excess_precision`` off (its Pallas kernels in interpret
mode under ``bp8_fused``).

Tolerances:
  * ``chunked_softmax_xent`` — the summed loss within 1e-6 relative and
    the mask sum exact (f32 logsumexp and sums reduce in another order);
  * ``DecoderModel.loss`` — within 2e-5 absolute on losses of ~6.5
    (observed <= 1.5e-5 on qwen2 in bf16, <= 1e-6 elsewhere); the Gemma
    family's tied std-1 embedding gives losses of ~50 on its smoke
    configs, where the tolerance is 8 times that (``LOSS_SCALE``), the
    same precision relative to the loss (observed <= 1.9e-5, 5 f32 ulps,
    on paligemma in ``bp8_fused``); paligemma's batches carry seeded
    patch embeddings for its prefix; granite-moe and minicpm3 tie std-1
    embeddings too (losses of ~37 and ~27): 8 times as well;
  * the MoE archs' loss in ``bf16`` — 1e-3 absolute (observed 3.3e-4 on
    granite-moe's ~37.5 and 3.2e-4 on deepseek-v2's ~6.6, against
    <= 1.5e-5 for the dense archs): their routed experts are plain bf16
    matmuls, which torch and XLA round one bf16 ulp apart now and then
    (``test_torch_moe.py``); the top-k sets are equal.  In the BP modes
    the dense rule holds (with the aux loss); the MoE and MLA archs run
    in ``bf16``, ``bp8`` and ``bp8_fused``;
  * per-leaf gradients — the largest difference within 5e-2 of the leaf's
    largest magnitude and a cosine similarity of at least 0.9998.  The
    backward runs through the bf16 residual stream: each cast to bf16
    rounds a gradient that differs in its last bits, so whole leaves
    differ at bf16 resolution (observed <= 2.6e-2, on qwen2's q bias, and
    cosine >= 0.9999).  The reference's own gradients with and without
    excess precision differ by up to 0.17 on the same leaves;
  * remat on and off — gradients bitwise equal (the recomputed forward
    is the same computation).
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.params import abstract_tree, init_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import (init_params, tree_leaves,  # noqa: E402
                                       tree_map)

EXACT = {"xla_allow_excess_precision": False}
#: absolute loss tolerances scale with the loss's magnitude (docstring)
LOSS_SCALE = {"gemma3_12b": 8.0, "paligemma_3b": 8.0, "granite_moe_1b": 8.0,
              "minicpm3_4b": 8.0}
#: (arch, mode) loss tolerances other than the rule above (docstring)
LOSS_TOL = {("granite_moe_1b", "bf16"): 1e-3,
            ("deepseek_v2_236b", "bf16"): 1e-3}


def to_np(tree):
    """Reference arrays -> numpy; bf16 leaves as (exact) float32."""
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


@pytest.mark.parametrize("s,chunk,softcap", [(64, 16, None), (70, 16, None),
                                             (40, 512, None), (70, 32, 30.0)])
def test_chunked_softmax_xent_matches_reference(s, chunk, softcap, rng):
    b, d, v = 3, 24, 97
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    e = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    fn = jax.jit(lambda *a: jlayers.chunked_softmax_xent(
        *a, chunk=chunk, softcap=softcap), compiler_options=EXACT)
    jt, jd = fn(jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(e),
                jnp.asarray(labels), jnp.asarray(mask))
    tt, td = tlayers.chunked_softmax_xent(
        torch.from_numpy(h).bfloat16(), torch.from_numpy(e),
        torch.from_numpy(labels), torch.from_numpy(mask), chunk=chunk,
        softcap=softcap)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert float(td) == float(jd) == mask.sum()


def _setup(arch, mode, remat=True):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               matmul_mode=mode)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               matmul_mode=mode, remat=remat)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = init_tree(jm.schema(), jax.random.key(0))
    batch = batch_at(DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                global_batch=4), 0)
    if jcfg.num_prefix_tokens:         # the stub vision tower's output
        batch["patches"] = np.random.default_rng(1).normal(size=(
            4, jcfg.num_prefix_tokens, jcfg.d_model)).astype(np.float32)
    return jm, tm, jp, batch


def _port_loss_and_grads(tm, params, batch):
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = tm.loss(live, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in tree_leaves(live)])
    loss = loss.detach()
    assert float(metrics["loss"]) == float(loss)
    return loss, dict(zip([p for p, _ in tree_leaves(live)], grads))


@pytest.mark.parametrize("arch,mode", [
    pytest.param(a, m, id=f"{a}-{m}")
    for a in ("h2o_danube_1p8b", "qwen2_72b", "gemma3_12b", "paligemma_3b",
              "granite_moe_1b", "deepseek_v2_236b", "minicpm3_4b")
    for m in ("bf16", "bp8", "bp8_fused", "fp8")
    if m != "fp8" or a in ("h2o_danube_1p8b", "qwen2_72b", "gemma3_12b",
                           "paligemma_3b")])
def test_loss_and_grads_match_reference(arch, mode):
    jm, tm, jp, batch = _setup(arch, mode)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True),
                          compiler_options=EXACT)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(to_np(jp), tm.cfg, "cpu")
    tl, tg = _port_loss_and_grads(tm, tp, batch)
    tol = LOSS_TOL.get((arch, mode), 2e-5 * LOSS_SCALE.get(arch, 1.0))
    assert abs(float(tl) - float(jl)) <= tol, (float(tl), float(jl))
    want = {tuple(k.key for k in path): np.asarray(
        g.astype(jnp.float32)) for path, g in
        jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(want) == sorted(tg)
    for path, g in tg.items():
        assert g.dtype == tp_leaf(tp, path).dtype, path
        r, got = want[path], g.float().numpy()
        big = np.abs(r).max()
        assert np.abs(got - r).max() <= 5e-2 * big, path
        cos = float(np.dot(got.ravel(), r.ravel())
                    / (np.linalg.norm(got) * np.linalg.norm(r)))
        assert cos >= 0.9998, (path, cos)


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b",
                                  "gemma3_12b", "paligemma_3b",
                                  "granite_moe_1b", "deepseek_v2_236b",
                                  "minicpm3_4b"])
def test_loss_metrics_match_reference(arch):
    """The metrics carry the reference's keys, shapes and dtypes (its
    abstract evaluation): ``aux_loss`` too, an f32 0.0 for the archs
    without experts."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jm, tm = jbuild(jcfg), build(tcfg)
    batch = batch_at(DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                global_batch=2), 0)
    if jcfg.num_prefix_tokens:
        batch["patches"] = np.zeros((2, jcfg.num_prefix_tokens,
                                     jcfg.d_model), np.float32)
    _, want = jax.eval_shape(jm.loss, abstract_tree(jm.schema()),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        _, got = tm.loss(init_params(tm.schema(), seed=0, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(np.dtype(want[k].dtype)), k
    if not tcfg.num_experts:
        assert float(got["aux_loss"]) == 0.0


def tp_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", ["bf16", "bp8_fused"])
def test_remat_on_and_off_give_equal_grads(mode):
    jm, tm, jp, batch = _setup("h2o_danube_1p8b", mode)
    tp = params_from_numpy(to_np(jp), tm.cfg, "cpu")
    l_on, g_on = _port_loss_and_grads(tm, tp, batch)
    off = build(dataclasses.replace(tm.cfg, remat=False))
    l_off, g_off = _port_loss_and_grads(off, tp, batch)
    assert torch.equal(l_on, l_off)
    for path in g_on:
        assert torch.equal(g_on[path], g_off[path]), path


def test_remat_recomputes_each_layer_in_the_backward():
    """With remat the backward runs each layer's forward again (the fused
    ops count a second call); without it, not."""
    from repro_torch.kernels import metrics
    from repro_torch.obs import MetricsRegistry
    jm, tm, jp, batch = _setup("h2o_danube_1p8b", "bp8_fused")
    tp = params_from_numpy(to_np(jp), tm.cfg, "cpu")
    calls = {}
    for remat in (True, False):
        reg = MetricsRegistry()
        prev = metrics.set_registry(reg)
        try:
            _port_loss_and_grads(build(dataclasses.replace(
                tm.cfg, remat=remat)), tp, batch)
        finally:
            metrics.set_registry(prev)
        calls[remat] = (reg.value("kernels.calls", kernel="fused_matmul"),
                        reg.value("kernels.calls", kernel="fused_mlp"))
    layers = tm.cfg.num_layers
    assert calls[False] == (5 * layers, layers)
    assert calls[True] == (10 * layers, 2 * layers)
