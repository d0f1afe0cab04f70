"""The port's tensor-parallel layers and pipeline executor against the
reference's sharded ones, on the CPU.

The reference runs in a subprocess over 4 forced host devices (its
multi-device code needs them before jax is imported): ``mlp_apply``,
``gqa_apply`` (kv "shard" mode at tp 2, "group" at tp 4), ``moe_apply``
(8 experts over 2) and ``mla_apply`` (4 heads over 2) under
``use_stage_tp`` inside a ``shard_map`` over a model-only mesh, each
leaf entering with its at-rest spec (``stage_param_specs``), in
``bf16`` and ``bp8_fused``; and ``pipeline_apply``'s forward of the
reference tests' toy (residual ``tanh`` layers) over 4 stages.  Under
jax 0.9 these still run (the reference's pipelined *training* does not:
ROADMAP Queue 1 item 5).  The port's counterparts run on 2 and 4 gloo
ranks of their own (``_torch_dist_cases``): each layer on its rank's
pieces of the same weights, under the per-shard plan.

Tolerances: in ``bp8_fused`` a layer's output bitwise the reference's
(both take each rank's scales on its own pieces and sum the ranks'
bf16-cast partial outputs); in ``bf16`` within 2^-7 of its largest
magnitude (one bf16 ulp there; observed <= 0.0055, and the MoE layer,
whose experts are plain bf16 matmuls, equal): the port runs a split bf16
matmul in f32 and sums its partials before one cast where the
reference sums bf16 partials.  The toy pipeline in f32: forward within 1e-5 of the
reference's; ``pipeline_grads`` under both schedules gives the
sequential autograd's y, dW and dX within 1e-5 (the reference's own
executor test's rule).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import _torch_dist_cases as cases  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: (name, layer, arch, tp): the layers held to the reference's shard_map
LAYERS = [("mlp2", "mlp", "h2o_danube_1p8b", 2),
          ("mlp4", "mlp", "h2o_danube_1p8b", 4),
          ("gqa_shard", "gqa", "h2o_danube_1p8b", 2),
          ("gqa_group", "gqa", "h2o_danube_1p8b", 4),
          ("moe_ep", "moe", "granite_moe_1b", 2),
          ("mla", "mla", "minicpm3_4b", 2)]
MODES = ("bf16", "bp8_fused")
TOY = {"S": 4, "L_PER": 2, "M": 8, "B": 2, "D": 16}


def _defs(layer, cfg):
    if layer == "mlp":
        return L.mlp_defs(cfg.d_model, cfg.d_ff, True)
    if layer == "gqa":
        return A.gqa_defs(cfg)
    if layer == "mla":
        return A.mla_defs(cfg)
    return MOE.moe_defs(cfg)


def _weights(defs, seed):
    """Seeded weights of a layer's schema, as f32 numpy holding values
    of each leaf's dtype (norm gammas drawn too, to exercise them)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, d in tree_leaves(defs):
        fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        w = rng.normal(size=d.shape).astype(np.float32) / np.sqrt(fan)
        if len(d.shape) == 1:
            w = 0.1 * w * np.sqrt(fan)
        w = torch.from_numpy(w).to(d.dtype).float().numpy()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = w
    return out


def _layer_inputs():
    rng = np.random.default_rng(7)
    out = []
    for name, layer, arch, tp in LAYERS:
        for mode in MODES:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      matmul_mode=mode)
            defs = _defs(layer, cfg)
            x = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model)).astype(
                np.float32)).to(torch.bfloat16).float().numpy()
            out.append((f"{name}-{mode}", {
                "kind": "layer", "layer": layer, "arch": arch, "mode": mode,
                "tp": tp, "mesh": {"data": 1, "model": tp}, "x": x,
                "params": _weights(defs, len(out)),
                "axes": tree_map(lambda d: ("stack",) + d.axes, defs),
                "dtypes": tree_map(lambda d: d.dtype, defs)}))
    return out


def _toy_inputs():
    t = TOY
    rng = np.random.default_rng(0)
    return {"W": (rng.standard_normal((t["S"] * t["L_PER"], t["D"], t["D"]))
                  * 0.1).astype(np.float32),
            "X": rng.standard_normal((t["M"], t["B"], t["D"])).astype(
                np.float32),
            "GY": rng.standard_normal((t["M"], t["B"], t["D"])).astype(
                np.float32)}


REF_SCRIPT = r'''
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_config
from repro.dist import tp as mtp
from repro.dist.pipeline import pipeline_apply, stack_stages
from repro.models import attention as A, layers as L, moe as MOE
src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    layer_cases, toy = pickle.load(f)
out = {}
for name, c in layer_cases:
    cfg = dataclasses.replace(get_config(c["arch"], smoke=True),
                              matmul_mode=c["mode"])
    mesh = Mesh(np.array(jax.devices()[:c["tp"]]), ("model",))
    plan = mtp.plan_stage_tp(cfg, mesh)
    specs = mtp.stage_param_specs(plan, {c["layer"]: c["axes"]})
    specs = jax.tree.map(lambda s: P(*tuple(s)[2:]), specs[c["layer"]],
                         is_leaf=lambda s: isinstance(s, P))
    params = jax.tree.map(lambda w, d: jnp.asarray(w).astype(d),
                          c["params"], c["jdtypes"])
    x = jnp.asarray(c["x"], jnp.bfloat16)
    b, s, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def body(p, x, c=c, cfg=cfg, plan=plan, pos=pos):
        with mtp.use_stage_tp(plan):
            if c["layer"] == "mlp":
                return L.mlp_apply(p, x, cfg.act, True, cfg.matmul_mode)
            if c["layer"] == "gqa":
                return A.gqa_apply(p, cfg, x, pos, window=cfg.window_size)[0]
            if c["layer"] == "mla":
                return A.mla_apply(p, cfg, x, pos)[0]
            return MOE.moe_apply(p, cfg, x)["out"]
    y = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P()),
                          out_specs=P(), check_rep=False))(params, x)
    out[name] = np.asarray(y.astype(jnp.float32))
W, X = jnp.asarray(toy["W"]), jnp.asarray(toy["X"])

def stage_fn(sp, x):
    def body(x, w):
        return x + jnp.tanh(x @ w), None
    return jax.lax.scan(body, x, sp)[0]
mesh = jax.make_mesh((4,), ("stage",))
out["toy_apply"] = np.asarray(pipeline_apply(stage_fn, stack_stages(W, 4),
                                             X, mesh))
with open(dst, "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
'''


def _jdtypes(tree):
    import jax.numpy as jnp
    names = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    return tree_map(lambda d: names[d], tree)


@pytest.fixture(scope="module")
def both():
    """The port's layers (2 and 4 ranks) and toy pipeline (2 and 4
    stages), started first; the reference's meanwhile."""
    import pickle
    layer_cases = _layer_inputs()
    toy = _toy_inputs()
    worlds = [cases.World(n, [(name, c) for name, c in layer_cases
                              if c["tp"] == n]
                          + [(f"toy{n}", {"kind": "toy",
                                          "mesh": {"stage": n}, **toy})])
              for n in (2, 4)]
    for _, c in layer_cases:
        c["jdtypes"] = _jdtypes(c.pop("dtypes"))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump((layer_cases, toy), f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        res = subprocess.run([sys.executable, "-c", REF_SCRIPT, src, dst],
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        with open(dst, "rb") as f:
            reference = pickle.load(f)
    port = {}
    for w in worlds:
        port.update(w.result())
    return reference, port


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


@pytest.mark.parametrize("name", [f"{n}-{m}" for n, *_ in LAYERS
                                  for m in MODES])
def test_tp_layer_matches_reference_sharded_layer(reference, port, name):
    want, got = reference[name], port[name]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if name.endswith("bp8_fused"):
        np.testing.assert_array_equal(got, want)
    big = np.abs(want).max()
    assert np.abs(got - want).max() <= 2.0 ** -7 * big, (
        name, np.abs(got - want).max(), big)


def _toy_sequential():
    t = _toy_inputs()
    W = torch.from_numpy(t["W"]).requires_grad_()
    X = torch.from_numpy(t["X"]).requires_grad_()
    y = cases._toy_stage(W, X)
    dW, dX = torch.autograd.grad(y, [W, X], torch.from_numpy(t["GY"]))
    return y.detach().numpy(), dW.numpy(), dX.numpy()


def test_pipeline_apply_matches_reference(reference, port):
    y, _, _ = _toy_sequential()
    for world in ("toy2", "toy4"):
        got = port[world]["apply"]
        assert np.abs(got - reference["toy_apply"]).max() < 1e-5, world
        assert np.abs(got - y).max() < 1e-5, world


@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
@pytest.mark.parametrize("world", ["toy2", "toy4"])
def test_pipeline_grads_match_sequential(port, world, sched):
    y, dW, dX = _toy_sequential()
    got = port[world][sched]
    for key, want in (("y", y), ("dW", dW), ("dX", dX)):
        err = np.abs(got[key] - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 1e-5, (world, sched, key, err)
