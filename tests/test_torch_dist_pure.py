"""The distributed layer's pure parts against the reference's, on the CPU.

Sharding rules (every preset on ``tests/test_sharding.py``'s and
``tests/test_dist_presets.py``'s mesh shapes and on production ones,
over every leaf of every arch's schema and the activations), the TP
plan and at-rest specs (all ten archs at tp 2, 4 and 8), the GPipe and
1F1B timetables over ``tests/test_pipeline.py``'s (S, M) grid, stage
stacking and its padded form, and the mesh shapes: all equal to the
reference's outputs.  A reference ``PartitionSpec`` is compared as the
tuple of its entries; its meshes are stubs (the functions read only
``mesh.shape``), or its ``jax.make_mesh`` is replaced by one that returns
its arguments.  Nothing here starts a rank.
"""
import types
import warnings

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import pipeline as jpp  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.dist import tp as jtp  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import axes_tree as jaxes_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import pipeline as pp  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist import tp as mtp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.params import axes_tree, tree_leaves  # noqa: E402

ARCHS = ["h2o_danube_1p8b", "gemma3_12b", "paligemma_3b", "qwen2_72b",
         "granite_moe_1b", "deepseek_v2_236b", "minicpm3_4b", "whisper_base",
         "zamba2_2p7b", "xlstm_1p3b"]
#: mesh shapes: the reference tests' (1, n) of one host device, and
#: production and host carvings
MESHES = [
    {"data": 1, "model": 1},
    {"data": 2, "model": 4},
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"stage": 4, "data": 4, "model": 16},
    {"stage": 2, "data": 1, "model": 2},
    {"seq": 4, "data": 4, "model": 16},
    {"seq": 2, "data": 2, "model": 2},
]
PRESETS = [("train", {}), ("prefill", {}), ("decode", {"batch": 1,
                                                       "data_size": 16}),
           ("decode", {"batch": 256, "data_size": 16}), ("pipeline", {}),
           ("dp_only", {}), ("sequence", {}), ("sp", {})]
#: activations and caches beside the params (logical names of the models)
ACTIVATIONS = [((8, 128, 2560), ("batch", "seq", None)),
               ((8, 128, 32000), ("batch", "seq", "vocab")),
               ((4, 4096, 8, 80), ("batch", "kv_seq", "kv_heads", None)),
               ((7,), ("heads",)), ((), ())]


def stub(shape):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _cases(arch):
    cases = list(ACTIVATIONS)
    sch = build(get_config(arch)).schema()
    for (_, d) in tree_leaves(sch):
        cases.append((d.shape, d.axes))
    return cases


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_spec_every_preset_and_mesh(arch):
    cases = _cases(arch)
    for phase, opts in PRESETS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want_rules = jshd.get_rules(phase, **opts)
        rules = shd.get_rules(phase, **opts)
        assert dict(rules) == dict(want_rules), phase
        for m in MESHES:
            for shape, axes in cases:
                want = tuple(jshd.partition_spec(stub(m), want_rules, shape,
                                                 axes))
                assert shd.partition_spec(stub(m), rules, shape, axes) == \
                    want, (phase, m, shape, axes)


def test_registry_aliases_and_context():
    assert shd.rule_phases() == jshd.rule_phases()
    assert sorted(shd.RULE_PRESETS) == sorted(jshd.RULE_PRESETS)
    assert shd.RULE_PRESETS["sp"] is shd.train_rules
    for name in ("train_rules", "prefill_rules", "pipeline_rules",
                 "dp_only_rules"):
        with pytest.warns(DeprecationWarning):
            got = getattr(shd, name)()
        with pytest.warns(DeprecationWarning):
            assert dict(got) == dict(getattr(jshd, name)())
    with pytest.warns(DeprecationWarning):
        assert dict(shd.decode_rules(1, 16)) == dict(
            shd.get_rules("decode", batch=1, data_size=16))
    with pytest.raises(ValueError, match="unknown parallelism phase"):
        shd.get_rules("nope")
    rules = shd.Rules({"a": "model", "b": ("data", "model")})
    assert rules.mesh_axes("a") == ("model",)
    assert rules.mesh_axes("b") == ("data", "model")
    assert rules.mesh_axes(None) == () and rules.mesh_axes("c") == ()
    mesh = stub({"data": 2, "model": 4})
    assert shd.current_ctx() is None
    with shd.use_rules(mesh, shd.get_rules("train")) as outer:
        assert shd.current_ctx() is outer
        with shd.use_rules(mesh, shd.get_rules("prefill")) as inner:
            assert shd.current_ctx() is inner
            with shd.suppress_rules():
                assert shd.current_ctx() is None
            assert shd.current_ctx() is inner
        assert shd.current_ctx() is outer
    assert shd.current_ctx() is None


def test_shard_is_a_checked_noop():
    x = torch.ones(4, 8)
    assert shd.shard(x, "batch", None) is x               # no context
    mesh = stub({"data": 2, "model": 4})
    with shd.use_rules(mesh, shd.get_rules("train")):
        assert shd.shard(x, "batch", "ffn") is x
        with pytest.raises(ValueError, match="not divisible"):
            shd.shard(torch.ones(3, 8), "batch", None)
        with pytest.raises(ValueError, match="names for"):
            shd.shard(x, "batch")


def test_tree_shardings_and_scalars():
    mesh = stub({"data": 2, "model": 4})
    rules = shd.get_rules("train")
    got = shd.tree_shardings(mesh, rules, {"w": (16, 32), "step": ()},
                             {"w": ("d_model", "ffn"), "step": ()})
    assert got == {"w": ("data", "model"), "step": ()}
    assert shd.named_sharding(mesh, rules, (), ()) == ()


# ---------------------------------------------------------------------------
# the TP plan and its specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_plan_and_stage_param_specs_match_reference(arch, tp, smoke):
    mesh = stub({"stage": 2, "data": 1, "model": tp})
    want = jtp.plan_stage_tp(jget_config(arch, smoke), mesh)
    got = mtp.plan_stage_tp(get_config(arch, smoke), mesh)
    assert dataclasses_equal(got, want)
    jsch = jbuild(jget_config(arch, smoke)).schema()
    if "layers" not in jsch:          # whisper, zamba2, xlstm: no stack
        assert "layers" not in build(get_config(arch, smoke)).schema()
        return
    jax_axes = jaxes_tree(jsch)["layers"]
    t_axes = axes_tree(build(get_config(arch, smoke)).schema())["layers"]
    try:
        want_specs = jtp.stage_param_specs(want, jax_axes)
    except AssertionError:            # a leaf whose axes lack "stack"
        with pytest.raises(ValueError, match="start with 'stack'"):
            mtp.stage_param_specs(got, t_axes)
        return
    got_specs = mtp.stage_param_specs(got, t_axes)
    flat_want = {path: tuple(spec) for path, spec in _spec_leaves(
        want_specs)}
    assert dict(_spec_leaves(got_specs)) == flat_want
    # the port's (L, ...) placements: the stage entry, then the TP dims
    for path, spec in _spec_leaves(mtp.layer_placements(got, t_axes)):
        assert spec == (flat_want[path][0],) + flat_want[path][2:], path


def dataclasses_equal(got, want):
    if want is None:
        return got is None
    return (got.axes, got.sizes, got.shard_heads, got.kv_mode,
            got.shard_ffn, got.shard_experts, got.shard_shared) == (
        want.axes, want.sizes, want.shard_heads, want.kv_mode,
        want.shard_ffn, want.shard_experts, want.shard_shared) and \
        got.size == want.size


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_spec_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tuple(tree))]


def test_param_placements_whole_outside_the_stack():
    cfg = get_config("deepseek_v2_236b", smoke=True)
    plan = mtp.plan_stage_tp(cfg, stub({"stage": 2, "model": 2}))
    pl = mtp.param_placements(axes_tree(build(cfg).schema()), plan, "stage")
    assert pl["embed"] == (None, None)
    assert pl["dense_layers"]["attn"]["wuk"] == (None, None, None, None)
    assert pl["layers"]["attn"]["wuk"] == ("stage", None, "model", None)
    assert pl["layers"]["moe"]["router"] == ("stage", None, None)
    no_tp = mtp.param_placements(axes_tree(build(cfg).schema()), None, None)
    assert no_tp["layers"]["moe"]["up"] == (None, None, None, None)


def test_plan_degrades_without_model_axis():
    cfg = get_config("qwen2_72b", smoke=True)
    assert mtp.plan_stage_tp(cfg, stub({"stage": 2, "data": 4})) is None
    assert mtp.plan_stage_tp(cfg, stub({"model": 1})) is None


# ---------------------------------------------------------------------------
# pipeline timetables and stacking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,M", [(1, 1), (1, 4), (2, 1), (2, 2), (4, 2),
                                 (4, 8), (3, 7), (8, 3)])
def test_schedules_match_reference(S, M):
    for name in ("gpipe", "1f1b"):
        want = jpp.SCHEDULES[name](S, M)
        got = pp.SCHEDULES[name](S, M)
        assert got.name == want.name and got.ticks == want.ticks
        np.testing.assert_array_equal(got.ops, want.ops)
        np.testing.assert_array_equal(got.mbs, want.mbs)
        assert got.idle_fraction == want.idle_fraction
        assert got.peak_activation_slots() == want.peak_activation_slots()
        assert np.isclose(got.idle_fraction, pp.bubble_fraction(S, M))
        for i in range(S):   # each stage's ops in tick order: M F, M B
            ops = got.stage_ops(i)
            assert [o for o, _ in ops].count(pp.FORWARD) == M
            assert [o for o, _ in ops].count(pp.BACKWARD) == M
    assert pp.bubble_fraction(S, M) == jpp.bubble_fraction(S, M)


@pytest.mark.parametrize("L,S", [(4, 2), (6, 3), (3, 2), (5, 4), (11, 4),
                                 (1, 1), (2, 4)])
def test_stack_stages_round_trips_and_padding(L, S):
    x = np.arange(L * 6, dtype=np.float32).reshape(L, 3, 2) + 1.0
    tree = {"w": torch.from_numpy(x), "b": torch.from_numpy(x[:, :, 0])}
    if L % S == 0:
        st = pp.stack_stages(tree, S)
        want = jpp.stack_stages({"w": x}, S)["w"]
        np.testing.assert_array_equal(st["w"].numpy(), np.asarray(want))
        back = pp.unstack_stages(st)
        assert torch.equal(back["w"], tree["w"])
        assert torch.equal(back["b"], tree["b"])
    else:
        with pytest.raises(ValueError, match="not divisible"):
            pp.stack_stages(tree, S)
    padded, valid = pp.stack_stages_padded(tree, S)
    jpad, jvalid = jpp.stack_stages_padded({"w": x}, S)
    np.testing.assert_array_equal(padded["w"].numpy(), np.asarray(jpad["w"]))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # the port runs each stage's real layers: the padded split's
    for s in range(S):
        lo, hi = pp.stage_layers(L, S, s)
        assert hi - lo == int(valid[s].sum())
        if hi > lo:
            assert torch.equal(padded["w"][s, :hi - lo], tree["w"][lo:hi])


# ---------------------------------------------------------------------------
# mesh shapes
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_meshes(monkeypatch):
    """The reference's mesh functions returning their (shape, axes)."""
    n = [1]
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: types.SimpleNamespace(
                            shape=dict(zip(axes, shape))))
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * n[0])
    return n


@pytest.mark.parametrize("kw", [{}, {"multi_pod": True},
                                {"pipeline_stages": 4},
                                {"pipeline_stages": 2, "multi_pod": True},
                                {"seq_shards": 8}])
def test_production_mesh_shapes(jax_meshes, kw):
    assert tmesh.make_production_mesh(**kw) == \
        jmesh.make_production_mesh(**kw).shape


@pytest.mark.parametrize("n,kw", [(4, {"model": 2}), (4, {"stages": 2}),
                                  (8, {"stages": 2, "model": 2}),
                                  (4, {"seq": 2, "model": 2}), (2, {}),
                                  (8, {"model": 8})])
def test_host_mesh_shapes(jax_meshes, n, kw):
    jax_meshes[0] = n
    assert tmesh.host_mesh_shape(n, **kw) == \
        jmesh.make_host_mesh(**kw).shape


def test_mesh_shape_refusals():
    with pytest.raises(ValueError, match="mutually exclusive"):
        tmesh.make_production_mesh(pipeline_stages=2, seq_shards=2)
    with pytest.raises(ValueError, match="must divide"):
        tmesh.make_production_mesh(pipeline_stages=3)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.host_mesh_shape(6, model=4)
    assert tmesh.mesh_axis_size(stub({"data": 2}), "stage") == 1
    assert tmesh.pick_backend("cpu", 4) == "gloo"
