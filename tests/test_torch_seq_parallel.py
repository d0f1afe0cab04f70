"""The port's sequence parallelism (``dist/seq.py`` and the ring core in
``models/attention.py``) against the reference's, on the CPU.

The reference's ring runs in one subprocess over 4 forced host devices,
on meshes built with ``jax.make_mesh(..., axis_types=Auto)``: under jax
0.9 its model-level ring fails on ``make_host_mesh``'s ``Explicit`` axes
(``with_sharding_constraint`` refuses them).  The port's runs on 4 gloo
CPU ranks of its own (``_torch_dist_cases``), started first; the core's
one-process oracles and the config helpers run here.

Tolerances:
  * the port's oracles (``_block_partials``, ``merge_block_partials``,
    ``ring_reference``, ``ring_mla_reference``) against the reference's,
    on the reference's ``RING_SCRIPT`` inputs: the equivalence
    contract's 1e-5 of the largest magnitude (XLA and torch sum the
    einsums and may fuse the merge's products in other orders); ``pad_kv``
    bitwise;
  * the port's ring (``ring_attend`` under both schedules,
    ``ring_attend_mla``) against the port's oracles: bitwise, on each
    rank's piece (the oracles cut the queries and KV as the ranks do);
    against the reference's ``ring_attend`` on the same mesh shape:
    1e-5;
  * the smoke decoders under the ring against the reference's ring on a
    (4, 1, 1) mesh: every call's logits within 1e-5 absolute times the
    arch's logit scale (``test_torch_model.py``'s rule: the BP codes and
    caches agree bit for bit, what is left is f32 reassociation), but
    granite-moe's within 5e-2: its routed experts are plain bf16 matmuls
    in every matmul mode, which torch and XLA accumulate in other orders
    (``test_torch_model.py``'s rule for deepseek-v2's in bf16; observed
    here: at one decode step layer 1's MoE output parts by 0.00195 on
    equal inputs, the logits by 0.027); each rank's cache block bitwise
    the matching cut of the reference's cache.  Under the ring every
    call's logits are bitwise the port's own calls without one.
"""
import dataclasses
import itertools
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_cases as cases  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.dist import seq as jseq  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.dist import seq as tseq  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEQ4 = {"seq": 4, "data": 1, "model": 1}
SEQ2_TP2 = {"seq": 2, "data": 1, "model": 2}
#: (name, arch, matmul mode, kv_quant, prompt length): prefill into a
#: cache of CACHE_LEN, then the DECODE_STEPS seeded tokens; 39 tokens do
#: not split over 4 ranks, so that prefill keeps its rows whole
MODEL_CASES = [("qwen2", "qwen2_72b", "bp8_fused", "bp8", 40),
               ("qwen2_rows_whole", "qwen2_72b", "bp8_fused", "bp8", 39),
               ("minicpm3", "minicpm3_4b", "bp8_fused", "none", 40),
               ("granite_moe", "granite_moe_1b", "bp8_fused", "bp8", 40)]
CACHE_LEN, DECODE_STEPS, BATCH = 48, 4, 2
#: the logits' tolerance against the reference's: 1e-5 times their
#: magnitude against qwen2's (``test_torch_model.py``); granite-moe's
#: bf16 experts 5e-2 (the module docstring)
LOGIT_TOL = {"qwen2_72b": 1e-5, "minicpm3_4b": 8e-5, "granite_moe_1b": 5e-2}
REFUSED = ("whisper_base", "zamba2_2p7b", "xlstm_1p3b")


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def ring_inputs(seed=0, b=2, sq=32, h=8, kh=4, d=16, skv=64):
    """The reference's ``RING_SCRIPT`` inputs (its shapes, a seeded rng):
    queries at the last ``sq`` positions of a ``skv``-token KV."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"q": rng.normal(size=(b, sq, h, d)).astype(f),
            "k": rng.normal(size=(b, skv, kh, d)).astype(f),
            "v": rng.normal(size=(b, skv, kh, d)).astype(f),
            "q_pos": np.broadcast_to(np.arange(skv - sq, skv)[None],
                                     (b, sq)).astype(np.int64).copy(),
            "kv_pos": np.broadcast_to(np.arange(skv)[None],
                                      (b, skv)).astype(np.int64).copy()}


def mla_inputs(seed=1, b=2, skv=64, r=24, p=8, h=6):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"qa": rng.normal(size=(b, 1, h, r)).astype(f),
            "qr": rng.normal(size=(b, 1, h, p)).astype(f),
            "ckv": rng.normal(size=(b, skv, r)).astype(f),
            "kr": rng.normal(size=(b, skv, p)).astype(f),
            "q_pos": np.full((b, 1), skv - 1, np.int64),
            "kv_pos": np.broadcast_to(np.arange(skv)[None],
                                      (b, skv)).astype(np.int64).copy()}


def _last(a):
    """Decode-style arguments: the last query only."""
    return dict(a, q=a["q"][:, -1:], q_pos=a["q_pos"][:, -1:])


def core_cases():
    """(name, case) of the ring-core cases: "kv" shards the rows over the
    ring (the KV blocks rotate), "stats" keeps them whole (the stats
    rotate), "schedules" runs both schedules on whole queries."""
    a = ring_inputs()
    rem = dict(_last(a), k=a["k"][:, :59], v=a["v"][:, :59],
               kv_pos=a["kv_pos"][:, :59])
    extra = dict(a, window=20, softcap=5.0,
                 prefix_len=np.array([40, 50], np.int64))
    return [("kv", {"op": "kv", "args": a}),
            ("kv_window_prefix_softcap", {"op": "kv", "args": extra}),
            ("stats", {"op": "stats", "args": _last(a)}),
            ("stats_remainder", {"op": "stats", "args": rem}),
            ("schedules", {"op": "schedules", "args": _last(a)}),
            ("tp", {"op": "kv", "args": ring_inputs(seed=1, sq=8, kh=2,
                                                    skv=32)}),
            ("mla", {"op": "mla", "args": mla_inputs(), "scale": 0.17})]


def model_inputs():
    """Per model case: the reference's ``init_tree`` weights (f32 numpy
    holding each leaf's values, and the leaf dtypes), seeded prompt and
    decode tokens."""
    out = []
    for i, (name, arch, mode, kvq, s) in enumerate(MODEL_CASES):
        cfg = dataclasses.replace(jbase.get_config(arch, smoke=True),
                                  matmul_mode=mode, kv_quant=kvq)
        schema = jbuild(cfg).schema()
        tree = jax.jit(lambda key: init_tree(schema, key))(jax.random.key(i))
        rng = np.random.default_rng(100 + i)
        out.append((name, {
            "arch": arch, "mode": mode, "kv_quant": kvq,
            "cache_len": CACHE_LEN,
            "params": jax.tree.map(
                lambda x: np.asarray(x.astype(jnp.float32)), tree),
            "dtypes": jax.tree.map(lambda x: str(x.dtype), tree),
            "tokens": rng.integers(3, cfg.vocab_size, (BATCH, s)),
            "decode": list(rng.integers(3, cfg.vocab_size,
                                        (DECODE_STEPS, BATCH)))}))
    return out


REF_SCRIPT = r'''
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.dist import seq as msq
from repro.dist import sharding as shd
from repro.models import build
src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    job = pickle.load(f)
EXACT = {"xla_allow_excess_precision": False}
rules = shd.get_rules("sequence")


def mesh_of(shape):
    # Auto axes: under jax 0.9 the model's sharding constraints refuse
    # make_host_mesh's Explicit ones
    return jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape))


def j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


out = {}
for mesh_shape, name, c in job["core"]:
    mesh = mesh_of(mesh_shape)
    a = {k: j(v) for k, v in c["args"].items()}
    kw = {k: a.pop(k) for k in ("window", "softcap") if k in a}
    if c["op"] == "mla":
        fn = lambda a: msq.ring_attend_mla(
            a["qa"], a["qr"], a["ckv"], a["kr"], a["q_pos"], a["kv_pos"],
            scale=c["scale"])
    else:
        fn = lambda a: msq.ring_attend(
            a["q"], a["k"], a["v"], a["q_pos"], a["kv_pos"],
            prefix_len=a.get("prefix_len"), **kw)
    with shd.use_rules(mesh, rules), msq.use_ring(mesh):
        o = jax.jit(fn, compiler_options=EXACT)(a)
    assert o is not None, name
    out[(tuple(mesh_shape.items()), name)] = np.asarray(o)

mesh = mesh_of({"seq": 4, "data": 1, "model": 1})
for name, c in job["model"]:
    cfg = dataclasses.replace(get_config(c["arch"], smoke=True),
                              matmul_mode=c["mode"], kv_quant=c["kv_quant"])
    model = build(cfg)
    params = jax.tree.map(lambda x, d: jnp.asarray(x).astype(d),
                          c["params"], c["dtypes"])
    s = c["tokens"].shape[1]
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(
        x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x), t)
    with shd.use_rules(mesh, rules), msq.use_ring(mesh):
        prefill = jax.jit(model.prefill, static_argnums=2,
                          compiler_options=EXACT)
        decode = jax.jit(model.decode_step, compiler_options=EXACT)
        lg, cache = prefill(params, {"tokens": jnp.asarray(c["tokens"])},
                            c["cache_len"])
        logits, caches = [np.asarray(lg)], [f32(cache["layers"])]
        for i, tok in enumerate(c["decode"]):
            lg, cache = decode(params, jnp.asarray(tok)[:, None], cache,
                               jnp.int32(s + i))
            logits.append(np.asarray(lg))
        caches.append(f32(cache["layers"]))
    out[name] = {"logits": logits, "caches": caches}
with open(dst, "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
'''


@pytest.fixture(scope="module")
def both():
    """The port's ring worlds (4 ranks: (seq 4) and (seq 2, model 2)),
    started first; the reference's ring meanwhile."""
    core = core_cases()
    models = model_inputs()
    port_models = [(name, {"kind": "ring_model", "mesh": SEQ4,
                           **{k: v for k, v in c.items() if k != "dtypes"}})
                   for name, c in models]
    world = cases.World(4, [
        ("core_seq4", {"kind": "ring_core", "mesh": SEQ4, "cases": core}),
        ("core_seq2_tp2", {"kind": "ring_core", "mesh": SEQ2_TP2,
                           "cases": core}),
        ("refusals_seq4", {"kind": "ring_refusals", "mesh": SEQ4,
                           "archs": REFUSED}),
        ("refusals_tp2", {"kind": "ring_refusals", "mesh": SEQ2_TP2,
                          "archs": ("qwen2_72b",)}),
    ] + port_models, timeout=240)
    job = {"core": [(m, name, c) for m in (SEQ4, SEQ2_TP2)
                    for name, c in core if c["op"] != "schedules"],
           "model": models}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        res = subprocess.run([sys.executable, "-c", REF_SCRIPT, src, dst],
                             capture_output=True, text=True, timeout=240,
                             env=env)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        with open(dst, "rb") as f:
            reference = pickle.load(f)
    return reference, world.result()


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


# ---------------------------------------------------------------------------
# the core in one process: the oracles against the reference's
# ---------------------------------------------------------------------------

VARIANTS = ("plain", "softcap", "window", "prefix", "remainder")


def _variant(variant, n):
    """RING_SCRIPT's inputs and keywords for one oracle variant (the
    remainder's 59-token KV padded to n blocks by each side's pad_kv)."""
    a = ring_inputs()
    kw = {"softcap": {"softcap": 5.0}, "window": {"window": 20},
          "prefix": {"prefix_len": np.array([40, 50], np.int64)}}.get(
              variant, {})
    if variant == "remainder":
        a = dict(a, k=a["k"][:, :59], v=a["v"][:, :59],
                 kv_pos=a["kv_pos"][:, :59])
    return a, kw


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_reference_matches_reference(n, variant):
    a, kw = _variant(variant, n)
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    total = -(-a["k"].shape[1] // n) * n
    tk = tseq.pad_kv(ta["k"], ta["v"], ta["kv_pos"], total)
    jk = jseq.pad_kv(ja["k"], ja["v"], ja["kv_pos"], total)
    got = tattn.ring_reference(ta["q"], *tk[:2], ta["q_pos"], tk[2],
                               n_blocks=n, **tkw)
    want = jattn.ring_reference(ja["q"], *jk[:2], ja["q_pos"], jk[2],
                                n_blocks=n, **jkw)
    _close(got.numpy(), np.asarray(want))
    # and against dense attention over the unpadded KV
    dense = tattn.sdpa(ta["q"], ta["k"], ta["v"], ta["q_pos"], ta["kv_pos"],
                       **tkw)
    _close(got.numpy(), dense.numpy())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_mla_reference_matches_reference(n):
    a = mla_inputs()
    t = [torch.from_numpy(a[k]) for k in ("qa", "qr", "ckv", "kr", "q_pos",
                                         "kv_pos")]
    j = [jnp.asarray(a[k]) for k in ("qa", "qr", "ckv", "kr", "q_pos",
                                    "kv_pos")]
    got = tattn.ring_mla_reference(*t, n_blocks=n, scale=0.17)
    want = jattn.ring_mla_reference(*j, n_blocks=n, scale=0.17)
    _close(got.numpy(), np.asarray(want))


def test_block_partials_and_merge_match_reference():
    a = ring_inputs()
    b, sq, h, d = a["q"].shape
    kh = a["k"].shape[2]
    qg = (a["q"].reshape(b, sq, kh, h // kh, d).transpose(0, 2, 3, 1, 4)
          / np.sqrt(np.float32(d))).astype(np.float32)
    kt = a["k"].transpose(0, 2, 1, 3)
    vt = a["v"].transpose(0, 2, 1, 3)
    kw = dict(causal=True, window=30, prefix_len=None, softcap=5.0)
    parts = []
    for j in range(4):
        cut = slice(16 * j, 16 * (j + 1))
        got = tattn._block_partials(
            torch.from_numpy(qg), torch.from_numpy(kt[:, :, cut]),
            torch.from_numpy(vt[:, :, cut]), torch.from_numpy(a["q_pos"]),
            torch.from_numpy(a["kv_pos"][:, cut]), **kw)
        want = jattn._block_partials(
            jnp.asarray(qg), jnp.asarray(kt[:, :, cut]),
            jnp.asarray(vt[:, :, cut]), jnp.asarray(a["q_pos"]),
            jnp.asarray(a["kv_pos"][:, cut]), **kw)
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w))
        parts.append([np.asarray(w) for w in want])
    stacked = [np.stack(x) for x in zip(*parts)]
    got = tattn.merge_block_partials(*(torch.from_numpy(x) for x in stacked))
    want = jattn.merge_block_partials(*(jnp.asarray(x) for x in stacked))
    _close(got.numpy(), np.asarray(want))


def test_pad_kv_is_exact():
    a = ring_inputs()
    cut = {k: a[k][:, :59] for k in ("k", "v", "kv_pos")}
    got = tseq.pad_kv(*(torch.from_numpy(cut[k]) for k in ("k", "v",
                                                           "kv_pos")), 64)
    want = jseq.pad_kv(*(jnp.asarray(cut[k]) for k in ("k", "v", "kv_pos")),
                       64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2][:, 59:] == -1).all() and (got[0][:, 59:] == 0).all()


def test_ring_attend_is_none_without_context_or_ring_rules():
    t = {k: torch.from_numpy(v) for k, v in ring_inputs().items()}
    args = (t["q"], t["k"], t["v"], t["q_pos"], t["kv_pos"])
    assert tseq.ring_attend(*args) is None
    mesh = types.SimpleNamespace(shape=dict(SEQ4))
    with tshd.use_rules(mesh, tshd.get_rules("prefill")), \
            tseq.use_ring(mesh):
        assert tseq.ring_attend(*args) is None
        assert tseq.kv_ring(2) is None and tseq.row_ring(2, 32) is None
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tseq.use_ring(types.SimpleNamespace(shape={"data": 4}))


@pytest.mark.parametrize("seq_shards", [1, 4])
def test_shapes_and_shape_applicable_match_reference(seq_shards):
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for arch in jbase.ARCH_IDS:
        tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
        assert tcfg.sub_quadratic == jcfg.sub_quadratic, arch
        for name in jbase.SHAPES:
            assert tbase.shape_applicable(
                tcfg, tbase.SHAPES[name], seq_shards) == \
                jbase.shape_applicable(jcfg, jbase.SHAPES[name],
                                       seq_shards), (arch, name)


# ---------------------------------------------------------------------------
# the ring on 4 and on 2 x 2 ranks
# ---------------------------------------------------------------------------

CORE_NAMES = [name for name, _ in core_cases()]


def _piece(want, op, coords, mesh_shape, heads):
    """The cut of the reference's whole output that the rank at
    ``coords`` holds: its rows for "kv", its heads where "model" splits
    them (GQA only)."""
    if op == "kv":
        per = want.shape[1] // mesh_shape["seq"]
        want = want[:, coords["seq"] * per:(coords["seq"] + 1) * per]
    if heads and mesh_shape["model"] > 1:
        per = want.shape[2] // mesh_shape["model"]
        want = want[:, :, coords["model"] * per:(coords["model"] + 1) * per]
    return want


def _coords(mesh_shape):
    return [dict(zip(mesh_shape, c)) for c in itertools.product(
        *(range(n) for n in mesh_shape.values()))]


@pytest.mark.parametrize("mesh", ["seq4", "seq2_tp2"])
@pytest.mark.parametrize("name", CORE_NAMES)
def test_ring_equals_port_oracle_bitwise(port, mesh, name):
    got = port[f"core_{mesh}"][name]
    assert all(got["bitwise"]), got["bitwise"]
    assert all(s > 0 for s in got["sends"]), got["sends"]


@pytest.mark.parametrize("mesh", ["seq4", "seq2_tp2"])
@pytest.mark.parametrize("name", [n for n in CORE_NAMES
                                  if n != "schedules"])
def test_ring_matches_reference_ring_attend(port, reference, mesh, name):
    shape = SEQ4 if mesh == "seq4" else SEQ2_TP2
    op = dict(core_cases())[name]["op"]
    want = reference[(tuple(shape.items()), name)]
    for piece, coords in zip(port[f"core_{mesh}"][name]["pieces"],
                             _coords(shape)):
        _close(piece, _piece(want, op, coords, shape, op != "mla"))


def test_ring_schedules_agree_bitwise(port):
    """kv and stats schedules on the same whole queries give the same
    bits (the "schedules" case's pair), on both meshes."""
    for mesh in ("seq4", "seq2_tp2"):
        assert all(port[f"core_{mesh}"]["schedules"]["bitwise"])


# ---------------------------------------------------------------------------
# the decoder under the ring
# ---------------------------------------------------------------------------

MODEL_NAMES = [c[0] for c in MODEL_CASES]


def _arch(name):
    return dict((c[0], c[1]) for c in MODEL_CASES)[name]


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_decoder_under_ring_matches_reference_ring(port, reference, name):
    got, want = port[name], reference[name]
    assert got["ranks_agree"]
    tol = LOGIT_TOL[_arch(name)]
    assert len(got["logits"]) == len(want["logits"]) == 1 + DECODE_STEPS
    for g, w in zip(got["logits"], want["logits"]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    # and bitwise the port's own calls without a ring
    for g, s in zip(got["logits"], got["single"]):
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_cache_blocks_match_reference_cut(port, reference, name):
    """Each rank's block of the cache, after prefill and after the decode
    steps, bitwise the matching cut of the reference's cache."""
    for got, want in zip(port[name]["caches"], reference[name]["caches"]):
        assert set(got) == set(want)
        for key, blocks in got.items():
            whole = np.asarray(want[key])
            c = blocks[0].shape[2]
            assert c * len(blocks) == whole.shape[2] == CACHE_LEN
            for r, block in enumerate(blocks):
                np.testing.assert_array_equal(
                    block, whole[:, :, r * c:(r + 1) * c].astype(
                        block.dtype), err_msg=f"{key} rank {r}")


def test_ring_decode_attends_the_dequantised_cache(port):
    """Under the ring a BP8 decode never calls the fused decode attention
    (row 4); without it, the same calls do."""
    for name in ("qwen2", "qwen2_rows_whole", "granite_moe"):
        assert port[name]["calls"]["row4"] == 0, name
        assert port[name]["single_calls"]["row4"] == 2 * DECODE_STEPS, name


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_scales_reduced_in_sharded_prefill_only(port, name):
    prefill, decode = port[name]["stats"]
    if name == "qwen2_rows_whole":   # rows whole: the scales are whole
        assert "all_reduce_max" not in prefill
    else:
        assert prefill.get("all_reduce_max", 0) > 0
    assert "all_reduce_max" not in decode
    # decode's one gather a step: the logits, computed on one rank
    assert decode["all_gather"] == DECODE_STEPS


def test_prefill_schedule_follows_the_rows(port):
    """Sharded rows rotate the KV blocks (k/v and positions: two messages
    a hop), whole rows the stats (one): 2 layers x 3 hops."""
    sharded, whole = port["qwen2"]["stats"][0], port["qwen2_rows_whole"][
        "stats"][0]
    assert sharded["send"] == 2 * 2 * 3
    assert whole["send"] == 2 * 3


def test_moe_routes_the_whole_sequence(port):
    """Under the ring each MoE layer routes the whole prompt's rows in
    prefill (capacity counts every row), one row a decode step."""
    rows = port["granite_moe"]["calls"]["moe_rows"]
    assert rows == [40] * 2 + [1] * 2 * DECODE_STEPS


def test_refusals(port):
    for arch in REFUSED:
        msg = port["refusals_seq4"][arch]
        assert msg and "decoder family only" in msg and "item 5c" in msg
    assert "item 5c" in port["refusals_seq4"]["prefill_chunk"]
    msg = port["refusals_tp2"]["qwen2_72b"]
    assert msg and "'model' axis" in msg and "item 5c" in msg
