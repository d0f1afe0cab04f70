"""The port's checkpoints: the reference's checkpoint cases re-run on the
port, and checkpoints crossing between the two packages.

The cases follow ``tests/test_checkpoint.py`` and
``tests/test_substrate.py``'s checkpoint tests: torn ``.tmp``
directories, a manifest that is required, flipped bytes in raw, payload
and residual files, bf16/fp16/fp8 leaves, retention, structure drift,
async and blocking saves byte-identical, the manager compressing only
the optimizer's moments, writer errors surfaced.  The cross-package
cases write with one package's manager and restore with the other's.

Tolerances: none — every restore is bitwise, and a checkpoint of the
same tree written by either package is byte-identical on disk.
"""
import json
import os
import threading

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _compat import given, settings, st  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JManager  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.ckpt import codec as codec_mod  # noqa: E402
from repro_torch.ckpt.checkpoint import (CheckpointCorruption,  # noqa: E402
                                         TreedefMismatch)
from repro_torch.ckpt.manager import (CheckpointManager,  # noqa: E402
                                      CheckpointWriteError,
                                      default_compress_filter)
from repro_torch.models.params import tree_leaves  # noqa: E402

TREE = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.linspace(-1, 1, 5),
        "n": torch.tensor(7, dtype=torch.int32)}


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _bitwise(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        codec_mod.leaf_bytes(a), codec_mod.leaf_bytes(b)))


def _flip_byte(path, offset=-1):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0xFF
    path.write_bytes(bytes(data))


def _dir_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# structure: jax's flattening order and treedef string, without jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", [
    {"b": {"c": 1, "a": np.zeros(2)}, "a": 3, "e": {}},
    {"state": {"opt": {"m": {"w": 1}, "v": {"w": 2}, "step": 3},
               "params": {"w": 4}},
     "extra": {"data": 5, "rng": 6}},
    {"K": 1, "_a": 2, "k1": 3},
    np.zeros(3),
])
def test_structure_matches_jax(tree):
    leaves, treedef = jax.tree.flatten(tree)
    assert ckpt.treedef_str(tree) == str(treedef)
    got = [x for _, x in tree_leaves(tree)]
    assert [id(x) for x in got] == [id(x) for x in leaves]
    back = ckpt.unflatten(tree, got)
    assert str(jax.tree.flatten(back)[1]) == str(treedef)


# ---------------------------------------------------------------------------
# atomicity / torn tmp
# ---------------------------------------------------------------------------

def test_torn_tmp_invisible_and_cleaned(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    torn = tmp_path / "step_000000002.tmp"
    torn.mkdir()
    (torn / "00000.npy").write_bytes(b"partial garbage")
    assert ckpt.all_steps(d) == [1]
    assert ckpt.latest_step(d) == 1
    assert ckpt.clean_torn(d) == ["step_000000002.tmp"]
    assert not torn.exists()
    back = ckpt.restore(d, 1, _like(TREE))
    assert _bitwise(back["w"], TREE["w"])


def test_manager_cleans_torn_tmp_at_init(tmp_path):
    torn = tmp_path / "step_000000005.tmp"
    torn.mkdir()
    CheckpointManager(str(tmp_path))
    assert not torn.exists()


def test_completed_dir_requires_manifest(tmp_path):
    (tmp_path / "step_000000003").mkdir()
    assert ckpt.all_steps(str(tmp_path)) == []


# ---------------------------------------------------------------------------
# integrity: crc a leaf
# ---------------------------------------------------------------------------

def test_raw_leaf_corruption_detected(tmp_path):
    ckpt.save(str(tmp_path), 1, TREE)
    _flip_byte(tmp_path / "step_000000001" / "00000.npy")
    with pytest.raises(CheckpointCorruption):
        ckpt.restore(str(tmp_path), 1, _like(TREE))


@pytest.mark.parametrize("name,what", [("00000.q.npy", "payload"),
                                       ("00000.r.z", "residual")])
def test_codec_file_corruption_detected(tmp_path, name, what):
    tree = {"m": TREE["w"]}
    ckpt.save(str(tmp_path), 1, tree, codecs=["int8_ef"])
    _flip_byte(tmp_path / "step_000000001" / name)
    with pytest.raises(CheckpointCorruption, match=what):
        ckpt.restore(str(tmp_path), 1, _like(tree))


# ---------------------------------------------------------------------------
# dtype round trips (the uint-view path and the codec)
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
def test_nonnative_dtype_roundtrip(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    arr = torch.randn((4, 8), generator=gen).to(dtype)
    ckpt.save(str(tmp_path), 1, {"x": arr})
    back = ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(4, 8)})
    assert _bitwise(back["x"], arr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_codec_roundtrip_bitwise(dtype):
    gen = torch.Generator().manual_seed(1)
    arr = torch.randn((64,), generator=gen).to(dtype)
    enc = codec_mod.encode_int8_ef(arr)
    dec = codec_mod.decode_int8_ef(enc.payload, enc.residual_z, enc.scale,
                                   enc.dtype, tuple(arr.shape))
    assert _bitwise(dec, arr)
    assert enc.payload_bytes == arr.numel()       # 1 byte an element


def test_codec_negative_zero_preserved():
    arr = torch.tensor([0.0, -0.0, 1.0, -1.0])
    enc = codec_mod.encode_int8_ef(arr)
    dec = codec_mod.decode_int8_ef(enc.payload, enc.residual_z, enc.scale,
                                   enc.dtype, (4,))
    assert _bitwise(dec, arr)


def test_codec_rejects_nonfinite_and_falls_back_to_raw(tmp_path):
    assert not codec_mod.encodable(torch.tensor([1.0, float("inf")]))
    assert not codec_mod.encodable(torch.tensor([1, 2], dtype=torch.int32))
    tree = {"x": torch.tensor([1.0, float("nan")])}
    ckpt.save(str(tmp_path), 1, tree, codecs=["int8_ef"])
    assert "codec" not in ckpt.read_manifest(str(tmp_path), 1)["leaves"][0]
    back = ckpt.restore(str(tmp_path), 1, _like(tree))
    assert _bitwise(back["x"], tree["x"])


def test_manifest_records_byte_accounting(tmp_path):
    tree = {"m": torch.zeros(128, 64)}
    ckpt.save(str(tmp_path), 1, tree, codecs=["int8_ef"])
    man = ckpt.read_manifest(str(tmp_path), 1)
    assert man["version"] == ckpt.MANIFEST_VERSION
    leaf = man["leaves"][0]
    assert leaf["raw_bytes"] == 128 * 64 * 4
    assert leaf["stored_bytes"] < leaf["raw_bytes"] // 2
    assert man["stored_bytes"] == leaf["stored_bytes"]


# ---------------------------------------------------------------------------
# retention, async == blocking, structure
# ---------------------------------------------------------------------------

def test_retention_keeps_exactly_newest(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        ckpt.save(d, s, TREE, keep=2)
    assert ckpt.all_steps(d) == [4, 5]
    for s in range(6, 8):
        ckpt.save(d, s, TREE, keep=0)              # keep=0: delete nothing
    assert ckpt.all_steps(d) == [4, 5, 6, 7]


def test_async_save_and_blocking_saves_byte_identical(tmp_path):
    state = {"opt": {"m": TREE["w"], "v": TREE["b"],
                     "step": torch.tensor(3, dtype=torch.int32)},
             "params": {"w": TREE["w"].bfloat16()}}
    a, b = tmp_path / "a", tmp_path / "b"
    ma, mb = CheckpointManager(str(a)), CheckpointManager(str(b))
    ma.save(1, state, blocking=True)
    mb.save(1, state, blocking=False)
    mb.wait_until_finished()
    assert _dir_bytes(a) == _dir_bytes(b)
    ma.close(), mb.close()
    t = ckpt.save(str(tmp_path / "c"), 7, TREE, blocking=False)
    assert isinstance(t, threading.Thread)
    t.join(timeout=60)
    assert not t.is_alive() and ckpt.latest_step(str(tmp_path / "c")) == 7


def test_treedef_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, TREE)
    renamed = {"w2": TREE["w"], "b": TREE["b"], "n": TREE["n"]}
    with pytest.raises(TreedefMismatch):
        ckpt.restore(d, 1, renamed)
    with pytest.raises(TreedefMismatch):
        ckpt.restore(d, 1, {"w": TREE["w"]})
    back = ckpt.restore(d, 1, renamed, strict_treedef=False)
    assert set(back) == {"w2", "b", "n"}


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_manager_compresses_only_opt_moments(tmp_path):
    state = {"params": {"w": TREE["w"]},
             "opt": {"m": TREE["w"], "v": TREE["w"],
                     "step": torch.tensor(1, dtype=torch.int32)}}
    m = CheckpointManager(str(tmp_path))
    rec = m.save(1, state, blocking=True)
    man = ckpt.read_manifest(str(tmp_path), 1)
    assert [leaf.get("codec") for leaf in man["leaves"]] == [
        "int8_ef", None, "int8_ef", None]    # opt.m, opt.step, opt.v, w
    assert rec.raw_bytes == 12 * 4 * 3 + 4
    back, step = m.restore(_like(state))
    assert step == 1
    for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(state)):
        assert _bitwise(a, b)
    m.close()


def test_default_compress_filter_paths():
    state = {"params": {"w": 0}, "opt": {"m": {"w": 0}, "v": {"w": 0},
                                         "step": 0}}
    picked = {path: default_compress_filter(path, leaf)
              for path, leaf in tree_leaves(state)}
    assert picked == {("opt", "m", "w"): True, ("opt", "step"): False,
                      ("opt", "v", "w"): True, ("params", "w"): False}


def test_manager_surfaces_writer_errors(tmp_path):
    m = CheckpointManager(str(tmp_path / "ok"))
    m.save(1, TREE, blocking=False)
    m.wait_until_finished()
    m.directory = "/proc/definitely/not/writable"
    m.save(2, TREE, blocking=False)
    with pytest.raises(CheckpointWriteError):
        m.wait_until_finished()


def test_manager_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_like(TREE))


def test_manager_overlap_accounting(tmp_path):
    m = CheckpointManager(str(tmp_path), write_throttle_s=0.2)
    rec = m.save(1, {"w": torch.zeros(64, 64)}, blocking=False)
    for _ in range(3):
        m.step_completed()
    m.wait_until_finished()
    assert rec.overlapped_steps >= 1
    m.close()


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _state_pair(rng):
    """One train-state-shaped tree for each package, the same values."""
    w = rng.normal(size=(6, 5)).astype(np.float32)
    m = (rng.normal(size=(6, 5)) * 1e-3).astype(np.float32)
    n = rng.normal(size=(5,)).astype(np.float32)
    jtree = {"state": {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16),
                                  "n": jnp.asarray(n)},
                       "opt": {"m": {"w": jnp.asarray(m),
                                     "n": jnp.asarray(n)},
                               "v": {"w": jnp.asarray(m * m),
                                     "n": jnp.asarray(n * n)},
                               "step": jnp.int32(9)}},
             "extra": {"data": np.asarray([0, 9, 4, 32], np.int64),
                       "rng": np.asarray(jax.random.key_data(
                           jax.random.key(5)))}}
    ttree = jax.tree.map(lambda a: torch.from_numpy(np.array(
        jnp.asarray(a).astype(jnp.float32) if a.dtype == jnp.bfloat16
        else a)), jtree)
    ttree["state"]["params"]["w"] = ttree["state"]["params"]["w"].bfloat16()
    return jtree, ttree


def _same(ttree, jtree, x64_restored=False):
    """Leaf for leaf the same bytes.  ``x64_restored``: ``jtree`` came back
    through the reference's ``device_put``, which (64-bit mode off) holds
    an int64 leaf as int32: such a leaf compares by value."""
    jl, jdef = jax.tree.flatten(jtree)
    assert ckpt.treedef_str(ttree) == str(jdef)
    for (_, t), j in zip(tree_leaves(ttree), jl):
        j = np.asarray(j)
        if x64_restored and t.dtype == torch.int64:
            assert j.dtype == np.int32
            np.testing.assert_array_equal(t.numpy(), j)
            continue
        assert codec_mod.dtype_name(t) == j.dtype.name
        assert tuple(t.shape) == j.shape
        assert codec_mod.leaf_bytes(t).numpy().tobytes() == j.tobytes()


def test_reference_checkpoint_restores_bitwise_in_port(tmp_path, rng):
    jtree, ttree = _state_pair(rng)
    jm = JManager(str(tmp_path))
    jm.save(9, jtree, blocking=True)
    jm.close()
    back, step = CheckpointManager(str(tmp_path)).restore(_like(ttree))
    assert step == 9
    _same(back, jtree)
    # the same tree written by the port is the same bytes on disk
    CheckpointManager(str(tmp_path / "port")).save(9, ttree, blocking=True)
    assert _dir_bytes(tmp_path / "port") == {
        k: v for k, v in _dir_bytes(tmp_path).items()
        if not k.startswith("port")}


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path, rng):
    jtree, ttree = _state_pair(rng)
    m = CheckpointManager(str(tmp_path))
    m.save(9, ttree, blocking=False)
    m.close()
    like = jax.tree.map(np.zeros_like, jtree)
    back, step = JManager(str(tmp_path)).restore(like)
    assert step == 9
    _same(ttree, back, x64_restored=True)
    man = json.loads((tmp_path / "step_000000009" / "manifest.json")
                     .read_text())
    assert [leaf.get("codec") for leaf in man["leaves"]].count(
        "int8_ef") == 4
    assert jckpt.read_manifest(str(tmp_path), 9) == man


# ---------------------------------------------------------------------------
# property tests (hypothesis; skipped when not installed).  Floats are
# f32 values (width=32) within +-1e30 rounded to f32: a bound that f32
# cannot hold is an invalid argument at width 32.
# ---------------------------------------------------------------------------

F32_1E30 = float(np.float32(1e30))
finite_f32 = st.floats(min_value=-F32_1E30, max_value=F32_1E30, width=32,
                       allow_nan=False, allow_infinity=False)


@settings(max_examples=50, deadline=None)
@given(st.lists(finite_f32, min_size=1, max_size=64))
def test_codec_roundtrip_property(xs):
    arr = torch.tensor(xs, dtype=torch.float32)
    if not codec_mod.encodable(arr):
        return
    enc = codec_mod.encode_int8_ef(arr)
    dec = codec_mod.decode_int8_ef(enc.payload, enc.residual_z, enc.scale,
                                   enc.dtype, tuple(arr.shape))
    assert _bitwise(dec, arr)


@settings(max_examples=25, deadline=None)
@given(st.lists(finite_f32, min_size=1, max_size=32))
def test_storable_roundtrip_property(xs):
    arr = torch.tensor(xs, dtype=torch.float32).bfloat16()
    store, logical = ckpt._storable(arr)
    assert store.dtype == np.uint16 and logical == "bfloat16"
    assert _bitwise(ckpt._unstorable(store, logical), arr)
