"""The port's tensor-parallel serving (``dist/serving.py`` and the decoder's
entry points under it) against the reference's, on the CPU.

The reference serves each case by ``jax.jit(model.prefill /
prefill_chunk / decode_step)`` with the rules' in- and out-shardings
under ``use_rules(mesh, get_rules("prefill" | "decode", ...))``, as its
dry-run lowers them.  It runs in subprocesses over 4 forced host devices
on ``Auto``-axes meshes (``make_host_mesh``'s ``Explicit`` axes make the
model's constraints refuse under jax 0.9), a share of the cases each,
with excess precision off.  The port's cases run on 4 gloo CPU ranks of
one world (``_torch_dist_cases``), started first.

Each case runs a prefill, a chunked prefill of two chunks into a fresh
cache (not paligemma's prefix) and 4 decode steps of seeded tokens, with
the model's bf16 weights and with f32 weights, each against the
reference.  Gates:
  * bf16 weights: layer 0's cache pieces on every rank bitwise the
    reference's cut (the vocab-split lookup is exact, the column-parallel
    projections take global scales over exact integer K sums, the KV
    quantisation is per (token, kv-head)); every call's logits within
    ``REF_BOUNDS`` of the reference's and its greedy token equal.  Where
    the reference's run under the rules is not its unsharded program
    (``REFERENCE_UNSHARDED``: GSPMD splits the routed experts' bf16
    contraction over "model" and XLA sums the bf16 partials; ROADMAP
    Queue 3, "Reference limits") the logits are held to its unsharded
    run, and the test shows the two runs part;
  * f32 weights, in the "bf16" matmul mode with a bf16 cache: every
    call's logits within 1e-5 of the largest |logit| of the reference's
    run under the rules (prefill) or 1e-4 (a call that reads the bf16
    cache), and of the same calls in the port's one process, where layer
    0's cache pieces are bitwise its cut.  What is left is the f32
    rounding of the row-parallel sums, which can round a bf16 cache entry
    the other way.  The BP modes are discontinuous: with f32 activations
    an f32 rounding of a row-parallel sum moves a later BP code a level
    (the logits of qwen2's smoke config by 1.2 of 2.9 in ``bp8_fused``),
    so their f32 runs gate nothing;
  * the params and the cache a call is given: another plan's pieces,
    whole params, a cache of other kv heads and the "prefill" rules'
    cache handed to the "decode" rules' fold raise (MLA's latent cache,
    whole under both, hands over);
  * each rank's ``cache_spec`` the rules' cut of the whole spec, but in
    "group" mode the one kv head its q heads read;
  * every leaf's elements on a rank the whole leaf's over its pieces;
  * the refusals raise, naming the ROADMAP item.
"""
import dataclasses
import math
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
from repro.models import build as jbuild  # noqa: E402
from repro.models.params import init_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import serving as sv  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist import tp as mtp  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
M4 = {"data": 1, "model": 4}
D2M2 = {"data": 2, "model": 2}
#: name: (arch, matmul mode, kv_quant, mesh, batch, phases of the prefill
#: and of the decode steps, config overrides).  qwen2's smoke config has
#: 2 kv heads: "group" mode at TP 4, "shard" at TP 2; at batch 1 the
#: "decode" rules fold "data" into "model" (TP 4 over both); granite-moe's
#: vocabulary of 515 does not split (its full one of 49155 neither)
CASES = {
    "qwen2_m4": ("qwen2_72b", "bp8_fused", "bp8", M4, 2,
                 ("prefill", "decode"), {}),
    "qwen2_d2m2": ("qwen2_72b", "bp8_fused", "bp8", D2M2, 2,
                   ("prefill", "decode"), {}),
    "qwen2_fold": ("qwen2_72b", "bp8_fused", "bp8", D2M2, 1,
                   ("decode", "decode"), {}),
    "qwen2_bf16": ("qwen2_72b", "bf16", "none", D2M2, 2,
                   ("prefill", "decode"), {}),
    "gemma3": ("gemma3_12b", "bp8_fused", "bp8", M4, 2,
               ("prefill", "decode"), {}),
    "paligemma": ("paligemma_3b", "bp8_fused", "bp8", D2M2, 2,
                  ("prefill", "decode"), {}),
    "minicpm3": ("minicpm3_4b", "bp8_fused", "none", M4, 2,
                 ("prefill", "decode"), {}),
    "deepseek": ("deepseek_v2_236b", "bp8_fused", "none", M4, 2,
                 ("prefill", "decode"), {}),
    "granite": ("granite_moe_1b", "bp8_fused", "bp8", M4, 2,
                ("prefill", "decode"), {"vocab_size": 515}),
}
#: cases whose reference run under the rules is not its unsharded
#: program: the routed experts' bf16 contraction split over "model"
#: (module docstring); their tokens are held to the unsharded run
REFERENCE_UNSHARDED = ("deepseek", "granite")
PROMPT, CHUNKS, CACHE_LEN, DECODE_STEPS = 24, (12, 12), 40, 4
#: reference subprocesses, each a share of the runs
REF_PROCS = 4
#: what every call's logits keep against the reference's with the
#: model's bf16 weights, by matmul mode: (the largest |difference| as a
#: share of the largest |logit|, 1 - the least row cosine).  Seen on the
#: CPU: 7.7e-5 and 2.8e-8 in bp8_fused (gemma3's third step; the rest
#: under 2e-7 and 4e-15), 7.4e-3 and 2.9e-5 in bf16 (its own rounding).
#: A fault shows far above: the ruled reference's bf16 expert partials
#: part it from its unsharded run by 0.19 and 0.027 (deepseek), 0.054
#: and 0.0033 (granite)
REF_BOUNDS = {"bp8_fused": (1e-3, 1e-6), "bf16": (3e-2, 1e-3)}
#: f32 weights: the prefill within 1e-5 of the largest |logit|, a call
#: that reads the bf16 cache within 1e-4 (seen: 3.8e-7 and 2.6e-5,
#: gemma3's second chunk)
F32_TOL = {"prefill": 1e-5, "cache": 1e-4}


def _jcfg(name):
    arch, mode, kvq, _, _, _, over = CASES[name]
    return dataclasses.replace(jbase.get_config(arch, smoke=True),
                               matmul_mode=mode, kv_quant=kvq, **over)


def _tcfg(name):
    arch, mode, kvq, _, _, _, over = CASES[name]
    return dataclasses.replace(get_config(arch, smoke=True),
                               matmul_mode=mode, kv_quant=kvq, **over)


def run_inputs():
    """Per run: the reference's ``init_tree`` weights (f32 numpy, with the
    leaf dtypes the run takes), seeded prompt, patches and decode
    tokens."""
    out = []
    for i, name in enumerate(CASES):
        arch, mode, kvq, mesh, b, phases, over = CASES[name]
        cfg = _jcfg(name)
        schema = jbuild(cfg).schema()
        tree = jax.jit(lambda key: init_tree(schema, key))(jax.random.key(i))
        params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                              tree)
        rng = np.random.default_rng(200 + i)
        base = {"arch": arch, "mode": mode, "kv_quant": kvq, "cfg": over,
                "mesh": mesh, "phases": phases, "cache_len": CACHE_LEN,
                "params": params,
                "tokens": rng.integers(3, cfg.vocab_size, (b, PROMPT)),
                "decode": list(rng.integers(3, cfg.vocab_size,
                                            (DECODE_STEPS, b))),
                "chunks": None if cfg.num_prefix_tokens else CHUNKS}
        if cfg.num_prefix_tokens:
            base["patches"] = rng.normal(size=(
                b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
        out.append((f"{name}-bf16", dict(
            base, w="bf16", unsharded=name in REFERENCE_UNSHARDED,
            dtypes=jax.tree.map(lambda x: str(x.dtype), tree))))
        out.append((f"{name}-f32", dict(
            base, w="f32", single=True, mode="bf16", kv_quant="none",
            unsharded=False,
            dtypes=jax.tree.map(lambda x: "float32", tree))))
    return out


REF_SCRIPT = r'''
import contextlib, dataclasses, functools, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.dist import sharding as shd
from repro.models import build
from repro.models.params import abstract_tree, axes_tree
src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    job = pickle.load(f)
EXACT = {"xla_allow_excess_precision": False}


def mesh_of(shape):
    # Auto axes: under jax 0.9 the model's sharding constraints refuse
    # make_host_mesh's Explicit ones
    return jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape))


def f32(t):
    return jax.tree.map(lambda x: np.asarray(
        x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x), t)


def run(c, ruled):
    cfg = dataclasses.replace(get_config(c["arch"], smoke=True),
                              matmul_mode=c["mode"], kv_quant=c["kv_quant"],
                              **c["cfg"])
    model = build(cfg)
    params = jax.tree.map(lambda x, d: jnp.asarray(x).astype(d),
                          c["params"], c["dtypes"])
    toks = jnp.asarray(c["tokens"])
    b, s = toks.shape
    length = c["cache_len"] + cfg.num_prefix_tokens
    batch = {"tokens": toks}
    if "patches" in c:
        batch["patches"] = jnp.asarray(c["patches"]).astype(jnp.bfloat16)
    mesh = mesh_of(c["mesh"])
    schema = model.schema()
    aparams, paxes = abstract_tree(schema), axes_tree(schema)
    acache = model.cache_spec(b, length)
    caxes = model.cache_axes(b, length)

    def layout(phase):
        opts = ({"batch": b, "data_size": c["mesh"].get("data", 1)}
                if phase == "decode" else {})
        rules = shd.get_rules(phase, **opts)
        return rules, {
            "p": shd.tree_shardings(mesh, rules, aparams, paxes),
            "c": shd.tree_shardings(mesh, rules, acache, caxes),
            "b": {k: shd.named_sharding(
                mesh, rules, v.shape, ("batch", "seq") + (None,) * (
                    v.ndim - 2)) for k, v in batch.items()}}

    def jitted(fn, ins, outs):
        if not ruled:
            return jax.jit(fn, compiler_options=EXACT)
        return jax.jit(fn, in_shardings=ins, out_shardings=outs,
                       compiler_options=EXACT)

    def ctx(rules):
        return shd.use_rules(mesh, rules) if ruled else \
            contextlib.nullcontext()

    out = {"logits": [], "caches": []}
    rules, sh = layout(c["phases"][0])
    with ctx(rules):
        prefill = jitted(functools.partial(model.prefill,
                                           cache_len=c["cache_len"]),
                         (sh["p"], sh["b"]), (None, sh["c"]))
        lg, cache = prefill(params, batch)
        out["logits"].append(np.asarray(lg))
        out["caches"].append(f32(cache))
        if c["chunks"]:
            chunk = jitted(model.prefill_chunk,
                           (sh["p"], {"tokens": sh["b"]["tokens"]}, sh["c"],
                            None), (None, sh["c"]))
            cc = jax.tree.map(lambda a: (jnp.full(a.shape, -1, a.dtype)
                                         if a.dtype == jnp.int32 else
                                         jnp.zeros(a.shape, a.dtype)), acache)
            lo = 0
            for n in c["chunks"]:
                lgc, cc = chunk(params, {"tokens": toks[:, lo:lo + n]}, cc,
                                jnp.int32(lo))
                out["logits"].append(np.asarray(lgc))
                lo += n
            out["caches"].append(f32(cc))
    rules, sh = layout(c["phases"][1])
    with ctx(rules):
        decode = jitted(model.decode_step,
                        (sh["p"], sh["b"]["tokens"], sh["c"], None),
                        (None, sh["c"]))
        for i, tok in enumerate(c["decode"]):
            lg, cache = decode(params, jnp.asarray(tok)[:, None], cache,
                               jnp.int32(s + cfg.num_prefix_tokens + i))
            out["logits"].append(np.asarray(lg))
        out["caches"].append(f32(cache))
    return out


res = {}
for name, c in job:
    res[name] = run(c, True)
    if c["unsharded"]:
        res[name]["unsharded"] = run(c, False)
with open(dst, "wb") as f:
    pickle.dump(res, f)
print("REF_OK")
'''


def _start_reference(runs, tmp):
    """``REF_PROCS`` subprocesses of ``REF_SCRIPT``, a share of ``runs``
    each; returns (process, output path) pairs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = []
    for i in range(REF_PROCS):
        share = runs[i::REF_PROCS]
        src, dst = (os.path.join(tmp, f"{k}{i}.pkl") for k in ("in", "out"))
        with open(src, "wb") as f:
            pickle.dump(share, f)
        procs.append((subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, src, dst],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env), dst))
    return procs


@pytest.fixture(scope="module")
def both():
    """The port's world (4 ranks, every case and the refusals), started
    first; the reference's runs meanwhile."""
    runs = run_inputs()
    port_runs = [(name, {"kind": "tp_serve", **{
        k: v for k, v in c.items() if k != "dtypes"}}) for name, c in runs]
    world = cases.World(4, port_runs + [
        ("refusals_d2m2", {"kind": "tp_refusals", "mesh": D2M2,
                           "calls": REFUSALS}),
        ("refusals_m4", {"kind": "tp_refusals", "mesh": M4,
                         "calls": ACCEPTED_M4}),
        ("layout", {"kind": "tp_layout", "mesh": D2M2,
                    "archs": LAYOUT_ARCHS})], timeout=300)
    reference = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start_reference(runs, tmp)
        for proc, dst in procs:
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for p, _ in procs:
                    p.kill()
                raise
            assert proc.returncode == 0, out[-3000:] + err[-3000:]
            with open(dst, "rb") as f:
                reference.update(pickle.load(f))
    return reference, world.result(), dict(runs)


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


@pytest.fixture(scope="module")
def inputs(both):
    return both[2]


BF16_RUNS = [f"{n}-bf16" for n in CASES]
F32_RUNS = [f"{n}-f32" for n in CASES]


def _calls(name):
    """The calls of a case in order: prefill, the chunks, the steps."""
    chunks = () if _jcfg(name).num_prefix_tokens else CHUNKS
    return (["prefill"] + [f"chunk {i}" for i in range(len(chunks))]
            + [f"decode {i}" for i in range(DECODE_STEPS)])


def _cut(whole, info, mla):
    """The rank's cut of a whole cache leaf (L, B, S, ...): its rows, and
    its kv heads."""
    lo, hi = info["rows"]
    out = whole[:, lo:hi]
    if out.ndim >= 4 and not mla:
        first, n = info["kv_heads"]
        out = out[:, :, :, first:first + n]
    return out


def _layer0_bitwise(got, want_caches, mla):
    """Every rank's cache pieces of the model's first layer (deepseek's
    first dense layer) against ``want_caches``' cut, after each run
    (prefill, the chunks, the decode steps)."""
    phases = ["prefill"] * (len(got["caches"]) - 1) + ["decode"]
    assert len(got["caches"]) == len(want_caches)
    for j, (pc, rc) in enumerate(zip(got["caches"], want_caches)):
        stack = "dense_layers" if "dense_layers" in pc else "layers"
        for key, parts in pc[stack].items():
            for rank, piece in enumerate(parts):
                cut = _cut(rc[stack][key], got["ranks"][rank][phases[j]],
                           mla)
                np.testing.assert_array_equal(
                    piece[0], cut[0],
                    err_msg=f"run {j} {stack}/{key} rank {rank}")


# ---------------------------------------------------------------------------
# the model's bf16 weights against the reference under the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", BF16_RUNS)
def test_layer0_cache_pieces_bitwise_reference_cut(port, reference, run):
    name = run.rsplit("-", 1)[0]
    _layer0_bitwise(port[run], reference[run]["caches"],
                    _jcfg(name).attention_type == "mla")


def _held_logits(port, reference, run):
    """(calls, the port's logits, the reference's) of a bf16-weight run:
    the reference's unsharded run for ``REFERENCE_UNSHARDED``."""
    name = run.rsplit("-", 1)[0]
    want = reference[run]
    if name in REFERENCE_UNSHARDED:
        want = want["unsharded"]
    got, want = port[run]["logits"], want["logits"]
    calls = _calls(name)
    assert len(got) == len(want) == len(calls)
    for call, a, b in zip(calls, got, want):
        assert a.shape == b.shape, (call, a.shape, b.shape)
    return calls, got, want


def _rel(a, b) -> float:
    b = b.astype(np.float64)
    return float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("run", BF16_RUNS)
def test_greedy_tokens_match_reference(port, reference, run):
    calls, got, want = _held_logits(port, reference, run)
    for call, a, b in zip(calls, got, want):
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1),
                                      err_msg=call)


@pytest.mark.parametrize("run", BF16_RUNS)
def test_logits_within_bounds_of_reference(port, reference, run):
    calls, got, want = _held_logits(port, reference, run)
    rel_max, cos_gap = REF_BOUNDS[CASES[run.rsplit("-", 1)[0]][1]]
    for call, a, b in zip(calls, got, want):
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        cos = min(float(x @ y / np.linalg.norm(x) / np.linalg.norm(y))
                  for x, y in zip(a64, b64))
        print(f"{run} {call}: {_rel(a, b):.3g} of the largest |logit|, "
              f"1 - cosine {1 - cos:.3g}")
        assert _rel(a, b) <= rel_max and 1 - cos <= cos_gap, (
            call, _rel(a, b), 1 - cos)


@pytest.mark.parametrize("name", REFERENCE_UNSHARDED)
def test_reference_under_the_rules_is_not_its_unsharded_program(reference,
                                                                 name):
    """What keeps these cases off the ruled reference: its run under the
    rules parts from its own unsharded run."""
    ruled = reference[f"{name}-bf16"]
    worst = max(float(np.abs(a - b).max()) for a, b in zip(
        ruled["logits"], ruled["unsharded"]["logits"]))
    assert worst > 1e-2, worst


@pytest.mark.parametrize("run", BF16_RUNS + F32_RUNS)
def test_every_rank_returns_the_whole_logits(port, run):
    assert port[run]["ranks_agree"]


# ---------------------------------------------------------------------------
# f32 weights against the reference and the port's one process
# ---------------------------------------------------------------------------

def _f32_held(got, want, run):
    calls = _calls(run.rsplit("-", 1)[0])
    assert len(got) == len(want) == len(calls)
    for call, a, b in zip(calls, got, want):
        assert a.shape == b.shape, (call, a.shape, b.shape)
        tol = F32_TOL["prefill" if call == "prefill" else "cache"]
        assert _rel(a, b) <= tol, (call, _rel(a, b))


@pytest.mark.parametrize("run", F32_RUNS)
def test_logits_f32_weights_match_reference(port, reference, run):
    """Against the reference's run under the rules (``F32_TOL``)."""
    _f32_held(port[run]["logits"], reference[run]["logits"], run)


@pytest.mark.parametrize("run", F32_RUNS)
def test_logits_f32_weights_match_one_process(port, run):
    """Against the same calls in the port's one process (``F32_TOL``)."""
    _f32_held(port[run]["logits"], port[run]["single"]["logits"], run)


@pytest.mark.parametrize("run", F32_RUNS)
def test_layer0_cache_pieces_bitwise_one_process_cut(port, run):
    name = run.rsplit("-", 1)[0]
    _layer0_bitwise(port[run], port[run]["single"]["caches"],
                    _jcfg(name).attention_type == "mla")


# ---------------------------------------------------------------------------
# the layout: cache specs, plans, bytes
# ---------------------------------------------------------------------------

def _rules(name, phase):
    _, _, _, mesh, b, _, _ = CASES[name]
    return sv.serving_rules(types.SimpleNamespace(shape=mesh), phase, b)


@pytest.mark.parametrize("name", list(CASES))
def test_cache_spec_is_the_rules_cut(port, name):
    """Each rank's ``cache_spec`` against the whole spec cut by the
    rules' placement of its axes; in "group" mode the head dim holds the
    one kv head its q heads read."""
    arch, mode, kvq, mesh, b, phases, over = CASES[name]
    cfg = _tcfg(name)
    model = build(cfg)
    length = CACHE_LEN + cfg.num_prefix_tokens
    whole = model.cache_spec(b, length)
    axes = model.cache_axes()
    shape = types.SimpleNamespace(shape=mesh)
    for phase in ("prefill", "decode"):
        rules = _rules(name, phases[0 if phase == "prefill" else 1])
        plan = sv.serving_plan(cfg, shape, rules)
        for rank, info in enumerate(port[f"{name}-bf16"]["ranks"]):
            coords = dict(zip(mesh, np.unravel_index(rank, tuple(
                mesh.values()))))
            for stack, leaves in whole.items():
                for key, (shp, _) in leaves.items():
                    pl = shd.partition_spec(shape, rules, shp,
                                            axes[stack][key])
                    want = []
                    for n, entry in zip(shp, pl):
                        ax = () if entry is None else (
                            (entry,) if isinstance(entry, str) else entry)
                        want.append(n // math.prod(mesh[a] for a in ax))
                    if (plan is not None and plan.kv_mode == mtp.KV_GROUP
                            and len(shp) >= 4):
                        want[3] = 1
                    assert tuple(info[phase]["spec"][stack][key]) == tuple(
                        want), (phase, rank, coords, stack, key)


@pytest.mark.parametrize("name", list(CASES))
def test_each_split_leaf_holds_its_share(port, name):
    """Every leaf's elements on a rank are the whole leaf's over the
    pieces its placement cuts it into."""
    model = build(_tcfg(name))
    _, _, _, mesh, b, phases, _ = CASES[name]
    shape = types.SimpleNamespace(shape=mesh)
    whole = {"/".join(k): math.prod(d.shape)
             for k, d in tree_leaves(model.schema())}
    for i, phase in enumerate(("prefill", "decode")):
        pl = dict(("/".join(k), v) for k, v in tree_leaves(
            sv.serve_placements(model, shape, _rules(name, phases[i]))))
        for info in port[f"{name}-bf16"]["ranks"]:
            got = info[phase]["param_elems"]
            for key, n in whole.items():
                pieces = math.prod(
                    mesh[a] for e in pl[key] if e is not None
                    for a in ((e,) if isinstance(e, str) else e))
                assert got[key] * pieces == n, (phase, key, pl[key])


def test_production_qwen2_pieces_are_a_quarter():
    """qwen2-72b at full width on (data 1, model 4): 16 of 64 q heads, 2
    of 8 kv heads, 7392 of 29568 ffn columns and 38016 of 152064
    vocabulary rows a rank; every leaf but the norms split."""
    cfg = get_config("qwen2_72b")
    model = build(cfg)
    shape = types.SimpleNamespace(shape=M4)
    rules = sv.serving_rules(shape, "prefill")
    plan = sv.serving_plan(cfg, shape, rules)
    assert plan.axes == ("model",) and plan.kv_mode == mtp.KV_SHARD
    assert sv.local_kv_heads(cfg, plan, 3) == (6, 2)
    pl = sv.serve_placements(model, shape, rules)
    for path, d in tree_leaves(model.schema()):
        p = pl
        for k in path:
            p = p[k]
        split = [i for i, e in enumerate(p) if e is not None]
        if path[-1] in ("ln1", "ln2", "final_norm"):
            assert not split, path
            continue
        assert len(split) == 1 and p[split[0]] == "model", (path, p)
        assert d.shape[split[0]] % 4 == 0
    assert pl["embed"] == ("model", None) and pl["head"] == (None, "model")
    assert cfg.vocab_size // 4 == 38016 and cfg.d_ff // 4 == 7392


def test_vocabulary_split_and_its_fallback():
    shape = types.SimpleNamespace(shape=D2M2)
    assert sv.vocab_axes(shape, sv.serving_rules(shape, "prefill"),
                         152064) == ("model",)
    fold = sv.serving_rules(shape, "decode", batch=1)
    assert sv.vocab_axes(shape, fold, 152064) == ("data", "model")
    assert sv.heads_axes(shape, fold) == ("data", "model")
    assert sv.vocab_axes(shape, fold, 49155) == ()
    assert sv.row_axes(shape, fold, 1) == ()
    assert sv.row_axes(shape, sv.serving_rules(shape, "decode", batch=2),
                       2) == ("data",)
    granite = build(get_config("granite_moe_1b"))
    pl = sv.serve_placements(granite, types.SimpleNamespace(shape=M4),
                             sv.serving_rules(shape, "prefill"))
    assert pl["embed"] == (None, None)


@pytest.mark.parametrize("arch,tp,want", [
    ("qwen2_72b", 4, [(0, 2), (2, 2), (4, 2), (6, 2)]),
    ("paligemma_3b", 2, [(0, 1), (0, 1)]),
    ("gemma3_12b", 16, [(i // 2, 1) for i in range(16)]),
    ("minicpm3_4b", 4, [(0, 40)] * 4),
    ("h2o_danube_1p8b", 3, [(0, 8)] * 3),
])
def test_local_kv_heads(arch, tp, want):
    cfg = get_config(arch)
    plan = mtp.plan_stage_tp(cfg, types.SimpleNamespace(
        shape={"data": 1, "model": tp}))
    assert [sv.local_kv_heads(cfg, plan, i) for i in range(tp)] == want


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

#: (name, arch, mode, batch, call) refused on (data 2, model 2)
REFUSALS = [
    ("whisper", "whisper_base", "bp8_fused", 2, "init_cache"),
    ("zamba2", "zamba2_2p7b", "bp8_fused", 2, "init_cache"),
    ("xlstm", "xlstm_1p3b", "bp8_fused", 2, "prefill"),
    ("granite_split_batch", "granite_moe_1b", "bp8_fused", 2, "prefill"),
    ("deepseek_split_batch", "deepseek_v2_236b", "bp8_fused", 2,
     "init_cache"),
    ("bp8_per_piece_scales", "qwen2_72b", "bp8", 2, "prefill"),
]
#: (arch, kv_quant, config overrides) of the params and cache checks at
#: batch 1 on (data 2, model 2): GQA in "shard" mode under the "prefill"
#: rules and "group" mode under the fold, granite-moe with its vocabulary
#: whole, and MLA, whose latent cache is the same under both
LAYOUT_ARCHS = [("qwen2_72b", "bp8", {}),
                ("granite_moe_1b", "bp8", {"vocab_size": 515}),
                ("minicpm3_4b", "none", {})]
#: calls a (model 4) mesh takes: MoE with its batch whole
ACCEPTED_M4 = [("granite_whole_batch", "granite_moe_1b", "bp8_fused", 2,
                "init_cache"),
               ("deepseek_whole_batch", "deepseek_v2_236b", "bp8_fused", 2,
                "init_cache")]
WANT = {"whisper": "5c(f)", "zamba2": "5c(f)", "xlstm": "5c(f)",
        "granite_split_batch": "5c(g)", "deepseek_split_batch": "5c(g)",
        "bp8_per_piece_scales": "5c(g)"}


@pytest.mark.parametrize("name", list(WANT))
def test_refusals_name_the_roadmap_item(port, name):
    got = port["refusals_d2m2"][name]
    assert got is not None and got[0] == "NotImplementedError", got
    assert f"ROADMAP Queue 1 item {WANT[name]}" in got[1], got


def test_moe_serves_with_its_batch_whole(port):
    assert port["refusals_m4"] == {n: None for n, *_ in ACCEPTED_M4}


@pytest.mark.parametrize("shape", [{"seq": 2, "data": 1, "model": 2},
                                   {"stage": 2, "data": 1, "model": 2}])
def test_serving_refuses_a_ring_or_stages(shape):
    with pytest.raises(NotImplementedError, match=r"item 5c\(a\)"):
        with sv.use_tp_serving(types.SimpleNamespace(shape=shape),
                               "prefill"):
            pass


def test_unknown_phase_raises():
    with pytest.raises(ValueError, match="serving phase"):
        sv.serving_rules(types.SimpleNamespace(shape=M4), "train")



# ---------------------------------------------------------------------------
# the params and the cache a call is given
# ---------------------------------------------------------------------------

GQA_LAYOUT = [a for a, *_ in LAYOUT_ARCHS if a != "minicpm3_4b"]


@pytest.mark.parametrize("arch", GQA_LAYOUT)
def test_fold_handover_of_the_prefill_cache_raises(port, arch):
    """The "prefill" rules' cache decoded under the fold at batch 1, with
    the fold's pieces: its kv heads are another rank's ("shard" over
    "model" against "group" over ("data", "model"); the same shapes)."""
    got = port["layout"][f"{arch}/handover"]
    assert got is not None and got[0] == "NotImplementedError", got
    assert "ROADMAP Queue 1 item 5c(g)" in got[1], got


@pytest.mark.parametrize("what", ["prefill_pieces", "whole_params"])
@pytest.mark.parametrize("arch", [a for a, *_ in LAYOUT_ARCHS])
def test_params_of_another_layout_raise(port, arch, what):
    """The "prefill" rules' pieces under the fold, and the whole params
    under "prefill": each call checks every leaf's shape."""
    got = port["layout"][f"{arch}/{what}"]
    assert got is not None and got[0] == "ValueError", got
    assert "serve_params" in got[1], got


@pytest.mark.parametrize("arch", GQA_LAYOUT)
def test_cache_of_other_kv_heads_raises(port, arch):
    """A cache made without a mesh (every kv head) under the fold."""
    got = port["layout"][f"{arch}/bare_cache"]
    assert got is not None and got[0] == "ValueError", got
    assert "init_cache" in got[1], got


def test_mla_latent_cache_hands_over(port):
    """MLA's latent cache is whole under both layouts: the fold takes the
    "prefill" rules' cache, and a cache made without a mesh, and decodes
    as the request served under the fold alone."""
    got = port["layout"]
    assert got["minicpm3_4b/handover"] is None
    assert got["minicpm3_4b/bare_cache"] is None
    a, b = got["minicpm3_4b/handover_logits"]
    assert _rel(a, b) <= F32_TOL["cache"], _rel(a, b)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
