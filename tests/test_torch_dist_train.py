"""Training on a mesh against single-device oracles, on the CPU.

The reference's pipelined and sharded training does not run under the
jax installed here (ROADMAP Queue 1 item 5), so the port's mesh steps
are held to single-device ones: ``DecoderModel.pipeline_loss`` on gloo
ranks of their own (``_torch_dist_cases``, 2 and 4 CPU ranks, each
world in one subprocess) against ``jax.value_and_grad`` of the
reference's unpipelined ``model.loss`` on the same weights and batch,
and against the single-process port.

Tolerances (dense stacks: equal up to float reassociation):
  * f32 weights (the h2o-danube smoke model cast to f32, ``bf16``
    matmul mode), pipelined over 2 stages in 2 microbatches (1F1B), its
    padded depth 3 on 2 stages, and data parallel over 2: the loss within
    1e-5 relative and every leaf's gradient within 1e-4 of its largest
    magnitude;
  * bf16 weights, pipelined (GPipe, 4 microbatches) and with TP inside
    the stages (2 x 2): the loss within 1e-5 relative and
    ``test_torch_loss.py``'s gradient rules against the reference (5e-2
    of the largest magnitude, cosine >= 0.9998);
  * stage-free TP in ``bp8_fused`` (global scales) against the
    single-process port, with the weights cast to f32: the loss within
    1e-5 relative and every leaf's gradient within 1e-4 of its largest
    magnitude (observed: the loss equal, the gradients within 3.7e-7);
    with bf16 weights the loss within 1e-5 relative (observed equal) and
    a cosine >= 0.99999 (observed >= 0.9999993): a backward through the
    bf16 residual stream in another order rounds some elements of a bf16
    leaf's gradient apart, up to 6e-3 of its largest magnitude.  The
    control, the same mesh's loss with each rank's scales taken on its
    own pieces (the stage mesh's rule, ``use_stage_tp(exact=False)``),
    parts: the loss more than 1e-4 relative apart, some leaf's cosine
    below 0.99;
  * the MoE aux loss, pipelined in 2 microbatches and data parallel over
    2: the reference's per-chunk redefinition, i.e. the mean over the
    (microbatch x data shard) chunks of the single-process port's loss
    on each chunk, within 1e-5 relative, and its gradients' mean with a
    cosine >= 0.9999 (bf16 gradients a chunk summed in f32);
  * granite-moe (experts over 2) and minicpm3 (MLA heads over 2) on
    (stage 2, model 2) in one microbatch against the single-process
    port: the loss within 1e-4 relative, cosine >= 0.9999;
  * the trainer's 5-step history on (stage 2, model 2) against the
    single-process trainer's: each loss within 1e-3 relative (observed
    1.4e-4: bf16 weights, the gradients summed in another order, then
    clipped and stepped);
  * a checkpoint written on that mesh restores bitwise without a mesh and
    on (data 2, model 2), and equals the mesh's final state gathered;
  * a mesh computes on the card unless asked for the CPU: without CUDA,
    one built with no device raises, and so does ``train`` on a CPU mesh
    without ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_cases as cases  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import (init_state,  # noqa: E402
                                          mesh_device)
from repro_torch.train.trainer import TrainerConfig, train  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}
ARCH = "h2o_danube_1p8b"
STEPS, SEQ, GB = 5, 16, 8


def _np(tree, f32=False):
    def one(a):
        a = a.astype(jnp.float32) if (f32 or a.dtype == jnp.bfloat16) \
            else a
        return np.array(a)
    return jax.tree.map(one, tree)


def _batch(vocab):
    return batch_at(DataConfig(vocab_size=vocab, seq_len=32,
                               global_batch=8), 0)


def _reference(f32, layers=None):
    """``jax.value_and_grad`` of the reference's ``model.loss`` on the
    port's seeded init (the ranks draw the same from seed 0)."""
    kw = {"num_layers": layers} if layers else {}
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                               matmul_mode="bf16", **kw)
    tcfg = cases.cfg_of(ARCH, "bf16", **kw)
    tp = init_state(build(tcfg), 0, OptimizerConfig(), "cpu")["params"]
    jm = jbuild(jcfg)
    jp = {}
    for path, t in tree_leaves(tp):
        node = jp
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = jnp.asarray(t.float().numpy())
        node[path[-1]] = a if f32 else a.astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    batch = _batch(jcfg.vocab_size)
    (loss, _), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True),
                           compiler_options=EXACT)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = {"/".join(k.key for k in path): np.asarray(v.astype(
        jnp.float32)) for path, v in
        jax.tree_util.tree_flatten_with_path(g)[0]}
    return {"batch": batch, "loss": float(loss), "grads": grads}


def _port_single(arch, mode, batch, seed=0, f32=False):
    """The single-process port's loss and f32 grads (init_state seed)."""
    cfg = cases.cfg_of(arch, mode)
    model = build(cfg)
    params = init_state(model, seed, OptimizerConfig(), "cpu")["params"]
    if f32:
        params = tree_map(lambda t: t.float(), params)
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(live, cases.torch_batch(batch))
    flat = [t for _, t in tree_leaves(live)]
    grads = torch.autograd.grad(loss, flat)
    return float(loss), {"/".join(p): g.float().numpy() for (p, _), g in
                         zip(tree_leaves(live), grads)}, \
        {"/".join(p): t.dtype for p, t in tree_leaves(params)}


def _chunks(batch, n):
    """The batch cut into n equal row chunks."""
    b = len(batch["tokens"])
    return [{k: v[i * b // n:(i + 1) * b // n] for k, v in batch.items()}
            for i in range(n)]


def _world2():
    batch, moe_batch = _batch(512), _batch(512)
    c = {
        "pipe_f32": {"kind": "loss", "mesh": {"stage": 2}, "arch": ARCH,
                     "mode": "bf16", "f32": True, "batch": batch, "M": 2,
                     "schedule": "1f1b"},
        "pipe_bf16": {"kind": "loss", "mesh": {"stage": 2}, "arch": ARCH,
                      "mode": "bf16", "batch": batch, "M": 4,
                      "schedule": "gpipe"},
        "pipe_padded": {"kind": "loss", "mesh": {"stage": 2}, "arch": ARCH,
                        "mode": "bf16", "cfg": {"num_layers": 3},
                        "f32": True, "batch": batch, "M": 2},
        "data2": {"kind": "loss", "mesh": {"data": 2}, "arch": ARCH,
                  "mode": "bf16", "f32": True, "batch": batch},
        "tp_bp8": {"kind": "loss", "mesh": {"data": 1, "model": 2},
                   "arch": ARCH, "mode": "bp8_fused", "batch": batch},
        "tp_bp8_f32": {"kind": "loss", "mesh": {"data": 1, "model": 2},
                       "arch": ARCH, "mode": "bp8_fused", "f32": True,
                       "batch": batch},
        "tp_bp8_per_shard": {"kind": "per_shard",
                             "mesh": {"data": 1, "model": 2}, "arch": ARCH,
                             "mode": "bp8_fused", "batch": batch},
        "moe_pipe": {"kind": "loss", "mesh": {"stage": 2},
                     "arch": "granite_moe_1b", "mode": "bf16",
                     "batch": moe_batch, "M": 2},
        "moe_data": {"kind": "loss", "mesh": {"data": 2},
                     "arch": "granite_moe_1b", "mode": "bf16",
                     "batch": moe_batch},
    }
    return cases.World(2, list(c.items()))


def _world4(ckpt_dir):
    mesh22 = {"stage": 2, "data": 1, "model": 2}
    c = [
        ("pipe22", {"kind": "loss", "mesh": mesh22, "arch": ARCH,
                    "mode": "bf16", "batch": _batch(512), "M": 2}),
        ("granite22", {"kind": "loss", "mesh": mesh22,
                       "arch": "granite_moe_1b", "mode": "bf16",
                       "batch": _batch(512)}),
        ("minicpm22", {"kind": "loss", "mesh": mesh22,
                       "arch": "minicpm3_4b", "mode": "bf16",
                       "batch": _batch(512)}),
        ("trainer", {"kind": "trainer", "mesh": mesh22, "arch": ARCH,
                     "mode": "bf16", "steps": STEPS, "seq": SEQ,
                     "batch": GB, "ckpt": ckpt_dir}),
        ("restore", {"kind": "restore", "mesh": {"data": 2, "model": 2},
                     "arch": ARCH, "mode": "bf16", "steps": STEPS,
                     "seq": SEQ, "batch": GB, "ckpt": ckpt_dir}),
    ]
    return cases.World(4, c)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


@pytest.fixture(scope="module")
def runs(ckpt_dir):
    """Both worlds started first; the references meanwhile."""
    w2, w4 = _world2(), _world4(ckpt_dir)
    ref = {"f32": _reference(True), "bf16": _reference(False),
           "padded": _reference(True, layers=3)}
    return ref, w2.result(), w4.result()


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world2(runs):
    return runs[1]


@pytest.fixture(scope="module")
def world4(runs):
    return runs[2]


def _check_loss(got, want, rel):
    assert abs(got - want) <= rel * abs(want), (got, want)


def _check_grads_tight(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _check_grads_bf16(got, want, rule=5e-2, cos=0.9998):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= rule * np.abs(w).max(), k
        assert _cos(got[k], w) >= cos, (k, _cos(got[k], w))


@pytest.mark.parametrize("case,kind", [("pipe_f32", "f32"),
                                       ("pipe_padded", "padded"),
                                       ("data2", "f32")])
def test_f32_mesh_step_matches_reference(world2, ref, case, kind):
    got, want = world2[case], ref[kind]
    _check_loss(got["loss"], want["loss"], 1e-5)
    _check_grads_tight(got["grads"], want["grads"])


@pytest.mark.parametrize("world,case", [("world2", "pipe_bf16"),
                                        ("world4", "pipe22")])
def test_bf16_pipelined_step_matches_reference(request, ref, world, case):
    got = request.getfixturevalue(world)[case]
    _check_loss(got["loss"], ref["bf16"]["loss"], 1e-5)
    _check_grads_bf16(got["grads"], ref["bf16"]["grads"])


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_stage_free_tp_bp8_fused_equals_single_process(world2, ref, f32):
    loss, grads, _ = _port_single(ARCH, "bp8_fused", ref["bf16"]["batch"],
                                  f32=f32)
    got = world2["tp_bp8_f32" if f32 else "tp_bp8"]
    _check_loss(got["loss"], loss, 1e-5)
    if f32:
        _check_grads_tight(got["grads"], grads)
    else:
        for k, w in grads.items():
            assert _cos(got["grads"][k], w) >= 0.99999, k


def test_per_shard_scales_are_another_function(world2, ref):
    """The control: the same TP step taking each rank's scales on its own
    pieces (the pipelined regime) parts from the unsharded step."""
    loss, grads, _ = _port_single(ARCH, "bp8_fused", ref["bf16"]["batch"],
                                  f32=True)
    got = world2["tp_bp8_per_shard"]
    assert abs(got["loss"] - loss) > 1e-4 * abs(loss)
    assert min(_cos(got["grads"][k], w) for k, w in grads.items()) < 0.99


@pytest.mark.parametrize("case,chunks", [("moe_pipe", 2), ("moe_data", 2)])
def test_moe_aux_is_the_per_chunk_mean(world2, case, chunks):
    parts = [_port_single("granite_moe_1b", "bf16", b)
             for b in _chunks(_batch(512), chunks)]
    loss = np.mean([p[0] for p in parts])
    got = world2[case]
    _check_loss(got["loss"], loss, 1e-5)
    for k in parts[0][1]:
        want = np.mean([p[1][k] for p in parts], axis=0)
        assert _cos(got["grads"][k], want) >= 0.9999, k


@pytest.mark.parametrize("case,arch", [("granite22", "granite_moe_1b"),
                                       ("minicpm22", "minicpm3_4b")])
def test_expert_and_latent_tp_in_stages_match_single_process(world4, case,
                                                             arch):
    loss, grads, _ = _port_single(arch, "bf16", _batch(512))
    got = world4[case]
    _check_loss(got["loss"], loss, 1e-4)
    for k, w in grads.items():
        assert _cos(got["grads"][k], w) >= 0.9999, k


def _single_trainer(ckpt=None, steps=STEPS):
    cfg = cases.cfg_of(ARCH, "bf16")
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=steps,
                         ckpt_dir=ckpt, ckpt_async=False,
                         ckpt_compress_opt=False)
    opt = OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                          total_steps=steps)
    return train(build(cfg), cfg, ShapeConfig("t", "train", SEQ, GB), tcfg,
                 opt_cfg=opt, device="cpu")


def test_trainer_history_on_a_mesh_matches_single_process(world4):
    _, hist = _single_trainer()
    want = [h["loss"] for h in hist]
    got = world4["trainer"]["losses"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        _check_loss(g, w, 1e-3)
    assert want[-1] < want[0] and got[-1] < got[0]


def test_mesh_checkpoint_restores_anywhere_bitwise(world4, ckpt_dir):
    assert tckpt.latest_step(ckpt_dir) == STEPS
    cfg = cases.cfg_of(ARCH, "bf16")
    model = build(cfg)
    like = {"state": init_state(model, 0, OptimizerConfig(), "cpu"),
            "extra": {"data": torch.zeros(4, dtype=torch.int64),
                      "rng": torch.zeros(2, dtype=torch.uint32)}}
    saved = tckpt.restore(ckpt_dir, STEPS, like)["state"]
    saved = {"/".join(k): v.float().numpy() for k, v in tree_leaves(saved)}
    for name in ("trainer", "restore"):       # the mesh's, and (2, 2)'s
        got = world4[name]["state"]
        assert sorted(got) == sorted(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{name} {k}")
    assert world4["restore"]["steps_run"] == 0
    # without a mesh: the trainer resumes at the last step and runs none
    state, hist = _single_trainer(ckpt=ckpt_dir)
    assert hist == []
    for k, v in tree_leaves(state):
        np.testing.assert_array_equal(v.float().numpy(), saved["/".join(k)])


def test_a_mesh_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        for make in (lambda: Mesh({"data": 1}), make_host_mesh):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
        mesh = make_host_mesh(device="cpu")
        assert mesh.device == torch.device("cpu")
        cfg = cases.cfg_of(ARCH, "bf16")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(build(cfg), cfg, ShapeConfig("t", "train", SEQ, GB),
                  TrainerConfig(total_steps=1), mesh=mesh)
        assert mesh_device(mesh, "cpu") == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="not the mesh's"):
            mesh_device(mesh, "cuda")
    finally:
        dist.destroy_process_group()
