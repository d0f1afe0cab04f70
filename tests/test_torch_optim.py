"""AdamW, the int8 error-feedback codec, the data pipeline, the train plan,
the train step and the train-state converters against the JAX reference,
on the CPU.

Inputs come from numpy seeds.

Tolerances:
  * ``lr_at`` and ``adamw_update`` (f32 and bf16 params and moments) —
    bitwise the reference run op by op (the same float expressions in the
    same order).  The update's gradients lie on a grid of 2**-4, so that
    every sum of squares in the norm is exact in any order.  The
    reference compiled with ``jit`` is not the yardstick here: XLA folds
    the constants (``1 - b1``, the clip scale) into the products in
    another order even with ``xla_allow_excess_precision`` off, which
    moves its own moments by up to 8 f32 ulps and its params by up to 4
    against its eager run (observed);
  * ``global_norm`` of such gradients bitwise; of any f32 values within
    2 ulps (torch and XLA reduce in other orders);
  * the compression codec, ``batch_at``, ``TrainPlan.for_shape`` and the
    converters — bitwise;
  * accumulation over 2 micro-batches against 1 — the loss within 2e-2
    (the reference's own bound in ``tests/test_trainer.py``) and the
    gradients' norm within 1e-2 relative.
"""
import dataclasses
import math

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import TrainPlan as JPlan  # noqa: E402
from repro.train.train_step import init_state as jinit_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, ShapeConfig  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import (train_state_from_numpy,  # noqa: E402
                                        train_state_to_numpy)
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import (TrainPlan, init_state,  # noqa: E402
                                          make_train_step)

def _ulps(got: float, want: float) -> float:
    """Distance in f32 units in the last place of ``want``."""
    return abs(got - want) / 2.0 ** (math.floor(math.log2(abs(want))) - 23)


def test_lr_at_matches_reference():
    for cfg in (jopt.OptimizerConfig(learning_rate=1e-3, warmup_steps=10,
                                     total_steps=100),
                jopt.OptimizerConfig(learning_rate=3e-3, warmup_steps=0,
                                     total_steps=7, min_lr_ratio=0.0)):
        tcfg = topt.OptimizerConfig(**{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg) if f.name != "moment_dtype"})
        for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
            got = float(topt.lr_at(tcfg, torch.tensor(step,
                                                      dtype=torch.int32)))
            assert got == float(jopt.lr_at(cfg, jnp.int32(step))), step


def _tree(rng, grid=None):
    """A small tree of f32 leaves; with ``grid``, rounded to multiples of
    it (few enough bits that their sums of squares are exact)."""
    tree = {"b": {"bias": rng.normal(size=(7,))},
            "w": rng.normal(size=(16, 12)) * 0.3,
            "z": rng.normal(size=(2, 3, 5))}
    snap = (lambda a: np.round(a / grid) * grid) if grid else (lambda a: a)
    return jax.tree.map(lambda a: snap(a).astype(np.float32), tree)


def test_global_norm_matches_reference(rng):
    tree = _tree(rng)
    got = float(topt.global_norm(_to_torch(tree)))
    assert _ulps(got, float(jopt.global_norm(jax.tree.map(jnp.asarray,
                                                          tree)))) <= 2
    grid = _tree(rng, 2.0 ** -4)
    assert float(topt.global_norm(_to_torch(grid))) == float(
        jopt.global_norm(jax.tree.map(jnp.asarray, grid)))


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def _to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype or a.dtype),
                        tree)


@pytest.mark.parametrize("pdtype", ["f32", "bf16"])
@pytest.mark.parametrize("mdtype", ["f32", "bf16"])
def test_adamw_update_matches_reference(pdtype, mdtype, rng):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    jcfg = jopt.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                total_steps=20, moment_dtype=jd[mdtype],
                                grad_clip=0.5)
    tcfg = topt.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                total_steps=20, moment_dtype=td[mdtype],
                                grad_clip=0.5)
    params = _tree(rng)
    jp = _to_jax(params, jd[pdtype])
    tp = _to_torch(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                jp), td[pdtype])
    jstate, tstate = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(
        tp, tcfg)
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    for _ in range(4):
        # each call from the same state on both sides: the update itself
        tp = _to_torch(jax.tree.map(f, jp), td[pdtype])
        tstate = {"m": _to_torch(jax.tree.map(f, jstate["m"]), td[mdtype]),
                  "v": _to_torch(jax.tree.map(f, jstate["v"]), td[mdtype]),
                  "step": torch.tensor(int(jstate["step"]),
                                       dtype=torch.int32)}
        grads = _tree(rng, 2.0 ** -4)
        jp, jstate, jm = jopt.adamw_update(jp, _to_jax(grads), jstate, jcfg)
        tp, tstate, tm = topt.adamw_update(tp, _to_torch(grads), tstate,
                                           tcfg)
        assert int(tstate["step"]) == int(jstate["step"])
        assert tstate["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == float(jm[k]), k
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            keys = [k.key for k in path]
            got = [tp, tstate["m"], tstate["v"]]
            want = [jp, jstate["m"], jstate["v"]]
            for k in keys:
                got = [t[k] for t in got]
                want = [t[k] for t in want]
            assert got[0].dtype == td[pdtype], keys
            assert got[1].dtype == got[2].dtype == td[mdtype], keys
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g.float().numpy(), f(w),
                                              err_msg=str((keys, i)))


def test_adamw_decays_matrices_only_and_casts_back():
    cfg = topt.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                               weight_decay=0.5)
    params = {"m": torch.ones(2, 2, dtype=torch.bfloat16),
              "v": torch.ones(2)}
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = topt.adamw_update(params, zero, topt.init_opt_state(
        params, cfg), cfg)
    assert new["m"].dtype == torch.bfloat16
    assert (new["m"] < 1).all() and torch.equal(new["v"], params["v"])


# ---------------- the int8 error-feedback codec ----------------

def test_compress_matches_reference_bitwise(rng):
    g = {"a": (rng.standard_normal((32, 16)) * 3).astype(np.float32),
         "b": np.zeros(5, np.float32)}
    r = {"a": (rng.standard_normal((32, 16)) * 1e-3).astype(np.float32),
         "b": np.zeros(5, np.float32)}
    # op by op, as the reference's own codec test runs it (under jit XLA
    # may contract the residual's multiply-subtract into an FMA)
    jq, js, jr = jcompress.compress(_to_jax(g), _to_jax(r))
    tq, ts, tr = tcompress.compress(_to_torch(g), _to_torch(r))
    for k in g:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert ts[k].numpy().tobytes() == np.asarray(js[k]).tobytes()
        assert tr[k].numpy().tobytes() == np.asarray(jr[k]).tobytes()
        # the host codec, leaf by leaf, bitwise the reference's mirror
        hq, hs, hr = tcompress.compress_leaf_host(g[k] + r[k])
        wq, ws, wr = jcompress.compress_leaf_host(g[k] + r[k])
        assert hq.tobytes() == wq.tobytes() and hs == ws
        assert hr.tobytes() == wr.tobytes()
        np.testing.assert_array_equal(tcompress.decompress_leaf_host(hq, hs),
                                      jcompress.decompress_leaf_host(wq, ws))
    back = tcompress.decompress(tq, ts)
    want = jcompress.decompress(jq, js)
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want[k]))
    zero = tcompress.init_residual(_to_torch(g))
    assert all(torch.equal(zero[k], torch.zeros(g[k].shape)) for k in g)


# ---------------- data ----------------

@pytest.mark.parametrize("seed,step,host_slice", [
    (1234, 0, None), (1234, 7, None), (0, 3, (1, 3)), (99, 100, (0, 1))])
def test_batch_at_bitwise(seed, step, host_slice):
    args = dict(vocab_size=512, seq_len=48, global_batch=4, seed=seed,
                mean_doc_len=32)
    got = tdata.batch_at(tdata.DataConfig(**args), step, host_slice)
    want = jdata.batch_at(jdata.DataConfig(**args), step, host_slice)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = tdata.iterate(tdata.DataConfig(**args), step, host_slice)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])


# ---------------- the train plan ----------------

@pytest.mark.parametrize("arch", [
    "h2o_danube_1p8b", "qwen2_72b", "deepseek_v2_236b",
    "granite_moe_1b-smoke", "deepseek_v2_236b-smoke"])
def test_train_plan_matches_reference_over_a_grid(arch):
    """The planner's arithmetic over a grid, its pipelined branch included
    (deepseek-v2's dense first layer outside the stages' weights); the
    pipelined step itself waits for ``dist/``."""
    arch, _, smoke = arch.partition("-")
    jcfg, tcfg = jget_config(arch, bool(smoke)), get_config(arch, bool(smoke))
    for seq, gb in ((128, 8), (4096, 256), (32, 4), (2048, 12)):
        for shards in (1, 2, 4, 8):
            for stages in (1, 2, 4):
                for tp_shards in (1, 4):
                    kw = dict(data_shards=shards, pipeline_stages=stages,
                              tp_shards=tp_shards)
                    got = TrainPlan.for_shape(tcfg, ShapeConfig(
                        "s", "train", seq, gb), **kw)
                    want = JPlan.for_shape(jcfg, JShape("s", "train", seq,
                                                        gb), **kw)
                    assert dataclasses.asdict(got) == dataclasses.asdict(
                        want), (seq, gb, kw)
                    assert got.bubble == want.bubble


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_param_bytes_match_reference(arch, smoke):
    """One pipelined-stack layer's bytes, which the planner charges per
    stage: deepseek-v2's dense first layer is outside the stack, so the
    stack's bytes divide by ``num_layers - first_dense_layers``."""
    from repro.train.train_step import _layer_param_bytes as jbytes
    from repro_torch.train.train_step import _layer_param_bytes as tbytes
    assert tbytes(get_config(arch, smoke)) == jbytes(jget_config(arch,
                                                                 smoke))


def test_pipelined_plan_and_mesh_raise():
    """A decoder's step builds on a mesh (``tests/test_torch_dist_*.py``
    run it); what still raises: a pipelined plan without a mesh or with
    another stage count, and the other families on any mesh (a stage
    mesh fails in the reference too: they have no ``pipeline_loss``)."""
    import types
    stub = lambda **shape: types.SimpleNamespace(shape=shape)  # noqa: E731
    model = build(get_config("h2o_danube_1p8b", smoke=True))
    cfg = topt.OptimizerConfig()
    assert callable(make_train_step(model, cfg, TrainPlan(1, 4),
                                    mesh=stub(data=1, model=2)))
    assert callable(make_train_step(
        model, cfg, TrainPlan(1, 4, pipeline_stages=2,
                              pipeline_microbatches=2),
        mesh=stub(stage=2, data=1, model=1)))
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(model, cfg, TrainPlan(1, 4, pipeline_stages=2))
    with pytest.raises(ValueError, match="pipelines over 2 stages"):
        make_train_step(model, cfg, TrainPlan(1, 4, pipeline_stages=2),
                        mesh=stub(stage=4, data=1, model=1))
    for arch in ("whisper_base", "zamba2_2p7b", "xlstm_1p3b"):
        other = build(get_config(arch, smoke=True))
        with pytest.raises(NotImplementedError,
                           match="stage mesh.*item 5c"):
            make_train_step(other, cfg, TrainPlan(1, 4, pipeline_stages=2),
                            mesh=stub(stage=2, data=1, model=1))
        with pytest.raises(NotImplementedError, match="a mesh is the"):
            make_train_step(other, cfg, TrainPlan(1, 4),
                            mesh=stub(data=2, model=1))


# ---------------- the train step ----------------

def test_grad_accumulation_equivalence():
    """accum=2 matches accum=1 on the same global batch (up to f32
    reassociation), as the reference's test of the same name."""
    cfg = get_config("qwen2_72b", smoke=True)
    model = build(cfg)
    opt = topt.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                               total_steps=10)
    state = init_state(model, 0, opt, "cpu")
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4)
    batch = {k: torch.from_numpy(v)
             for k, v in tdata.batch_at(dcfg, 0).items()}
    s1 = make_train_step(model, opt, TrainPlan(accum_steps=1, micro_batch=4))
    s2 = make_train_step(model, opt, TrainPlan(accum_steps=2, micro_batch=2))
    n1, m1 = s1(state, batch)
    n2, m2 = s2(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2
    assert math.isclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                        rel_tol=1e-2)
    assert int(n1["opt"]["step"]) == int(n2["opt"]["step"]) == 1
    # the step returns new tensors: the state it was given is untouched
    assert int(state["opt"]["step"]) == 0



def test_train_step_parts_run_under_their_ranges(tmp_path):
    """A profile of a step reads its parts from ``make_train_step``'s own
    ``train.*`` ranges: each once a micro-batch (the gradient sum once
    more, its division), in step order, with the model's matrix products
    inside the forward and, recomputed by the remat, inside the backward."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("h2o_danube_1p8b", smoke=True)
    model = build(cfg)
    opt = topt.OptimizerConfig(warmup_steps=2, total_steps=4)
    state = init_state(model, 0, opt, "cpu")
    dcfg = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4)
    batch = {k: torch.from_numpy(v)
             for k, v in tdata.batch_at(dcfg, 0).items()}
    step = make_train_step(model, opt, TrainPlan(accum_steps=2, micro_batch=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    import json
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("train."))
    assert [r[2] for r in ranges] == [
        "train.forward", "train.backward", "train.grad_sum"] * 2 + [
        "train.grad_sum", "train.adamw"]
    mms = [e["ts"] for e in events if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::mm", "aten::matmul", "aten::bmm")]
    for name in ("train.forward", "train.backward"):
        lo, hi, _ = next(r for r in ranges if r[2] == name)
        assert any(lo <= ts <= hi for ts in mms), name

def test_train_state_converters_round_trip():
    jcfg = jget_config("h2o_danube_1p8b", smoke=True)
    from repro.models import build as jbuild
    opt = jopt.OptimizerConfig()
    jstate = jinit_state(jbuild(jcfg), jax.random.key(3), opt)
    jstate["opt"]["m"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.25),
                                      jstate["params"])
    jstate["opt"]["step"] = jnp.int32(5)
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), jstate)
    state = train_state_from_numpy(tree, get_config("h2o_danube_1p8b",
                                                    smoke=True), "cpu")
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["m"]["embed"].dtype == torch.float32
    assert int(state["opt"]["step"]) == 5
    back = train_state_to_numpy(state)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b).reshape(np.shape(a)), a,
                                      err_msg=str(path))
