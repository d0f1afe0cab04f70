"""Plain versions of the redesigned kernels' schedules, on the CPU.

* The fused matmul encodes by comparison: ``|x| >= boundary`` with the
  plane boundaries of the scale (``ref.plane_boundaries``, the plain
  version of the kernel's bisection) gives bitwise the levels of the
  division form (``ref.bp_levels``) and of the JAX reference's
  ``quantize_bp``, on the boundaries, one ulp either side, and at random,
  tiny and huge scales.  A bf16 weight is compared as bits with the
  boundaries rounded up to bf16 (``ref.bf16_plane_boundaries``): the same
  planes for every bf16 value.  (At scale f32 ``tiny`` every nonzero |x| below
  the scale is subnormal, and XLA's CPU backend flushes subnormals to
  zero; there the JAX side is compared on the normal values only.)
* The BP quantise finds a value's level as the count of the 9 level
  boundaries it reaches (no division): over every finite bf16 pattern and
  at random f32 values that count gives the codes of the division form.
* The codes matmul encodes a code by a table of the plane bytes of the 19
  codes -9..9, and its K splits add their exact sums into the output in
  f32, in any order: the plain emulation of both equals
  ``bp_matmul_ref``.
* Decode attention splits the cache (``split_tokens``) and merges the
  splits' softmax partials; ``bp8_decode_attention_split_ref`` is that
  schedule as tensor code, held within 1e-5 of the JAX kernel (interpret
  mode, as the reference's tests run it) and of the plain version.
* The popcount kernel gives a row ``popcount_lanes(C)`` lanes of a warp
  and a warp ``32 / lanes`` rows; each lane reads the row's unaligned head
  and tail bytes and its aligned 16-byte words at a stride of ``lanes``,
  ``kUnroll`` words at a time, and the row's lanes fold their sums by xor
  shuffles.  The emulation of that schedule reads every byte exactly once
  and gives ``popcount_accumulate_ref``'s sums at every width 1..4096 and
  every misalignment of the tile's start.
"""
import math

import numpy as np
import pytest

from _torch_tests import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core.quantize import quantize_bp as j_quantize_bp  # noqa: E402
from repro.kernels import attention as jattn  # noqa: E402
from repro_torch.core.bp import plane_thresholds  # noqa: E402
from repro_torch.kernels import bp_matmul as tbpm  # noqa: E402
from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)
SCALES = [1.0, 5.128217, 0.37, 1e-20, 7.5e12, TINY, 3e38,
          float(np.finfo(np.float32).max)]


def _boundary_values(rng, scale):
    """|values| in [0, scale]: every level boundary, one ulp either side,
    random magnitudes, zero and the scale itself; random signs."""
    b = tref.level_boundaries(torch.tensor([[scale]])).numpy()
    up = np.nextafter(b, np.float32(np.inf))
    down = np.nextafter(b, np.float32(0))
    rand = (rng.random(4000) * scale).astype(np.float32)
    mag = np.concatenate([b, up, down, rand, [0.0, scale]]).astype(np.float32)
    mag = np.minimum(mag, np.float32(scale))
    return mag * rng.choice([-1.0, 1.0], mag.shape).astype(np.float32)


def _compare_levels(x, scale):
    """Levels as the count of boundaries |x| reaches."""
    b = tref.level_boundaries(scale)
    return (x.abs()[..., None] >= b).sum(-1).to(torch.float32)


@pytest.mark.parametrize("scale", SCALES)
def test_comparison_levels_equal_division_levels(scale, rng):
    x = torch.from_numpy(_boundary_values(rng, scale))
    s = torch.tensor(scale, dtype=torch.float32)
    want = tref.bp_levels(x, s)
    assert torch.equal(_compare_levels(x, s), want)
    jq = j_quantize_bp(jnp.asarray(x.numpy()))
    assert float(np.asarray(jq.scale).reshape(())) == np.float32(scale)
    normal = (x.abs() == 0) | (x.abs() >= TINY)
    assert int(normal.sum()) >= (2 if scale == TINY else len(x))
    assert np.array_equal(np.asarray(jq.levels).astype(np.float32)[normal],
                          want.numpy()[normal])


@pytest.mark.parametrize("which", ["right", "left"])
@pytest.mark.parametrize("scale", [5.128217, TINY, 3e38])
def test_plane_boundaries_give_the_planes(which, scale, rng):
    """Plane p set iff |x| >= plane_boundaries[p], as level >= threshold."""
    x = torch.from_numpy(_boundary_values(rng, scale))
    s = torch.tensor(scale, dtype=torch.float32)
    got = x.abs()[:, None] >= tref.plane_boundaries(s, which)
    t = torch.tensor(plane_thresholds(which), dtype=torch.float32)
    assert torch.equal(got, tref.bp_levels(x, s)[:, None] >= t)


def test_random_scales_boundaries_are_least(rng):
    """Each boundary reaches its level and the f32 below it does not."""
    for scale in np.exp(rng.uniform(-80, 80, 40)).astype(np.float32):
        s = torch.tensor(float(scale))
        b = tref.level_boundaries(s)
        lv = torch.arange(1, 10, dtype=torch.float32)
        assert torch.equal(tref.bp_levels(b, s) >= lv, torch.ones(9).bool())
        below = torch.nextafter(b, torch.zeros(9))
        assert not bool((tref.bp_levels(below, s) >= lv).any())


@pytest.mark.parametrize("which", ["right", "left"])
@pytest.mark.parametrize("scale", SCALES)
def test_bf16_boundaries_give_the_planes(which, scale):
    """Every bf16 bit pattern but the NaNs: the integer compare of
    bits(|v|) with the rounded-up bf16 boundary sets plane p iff the
    f32-widened value's level reaches the plane's threshold."""
    v = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    v = v.view(torch.bfloat16)
    v = v[~torch.isnan(v)]
    s = torch.tensor(scale, dtype=torch.float32)
    bits = v.view(torch.int16).to(torch.int32) & 0x7FFF
    got = bits[:, None] >= tref.bf16_plane_boundaries(s, which)
    t = torch.tensor(plane_thresholds(which), dtype=torch.float32)
    assert torch.equal(got, tref.bp_levels(v.float(), s)[:, None] >= t)


# ---------------------------------------------------------------------------
# BP quantise: levels by counting boundaries
# ---------------------------------------------------------------------------

def _every_bf16():
    v = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    v = v.view(torch.bfloat16)
    return v[torch.isfinite(v)]


def _counted_codes(x, scale):
    """The quantise kernel's codes: sign times the count of the level
    boundaries that |x| reaches (NaN boundaries none)."""
    x = x.float()
    b = tref.level_boundaries(scale)
    level = (x.abs()[..., None] >= b).sum(-1)
    return (torch.sign(x) * level).to(torch.int8)


@pytest.mark.parametrize("scale", SCALES + ["max"])
def test_boundary_count_quantises_every_bf16_pattern(scale):
    x = _every_bf16()
    s = (tref.tensor_scale(x.float()) if scale == "max"
         else torch.tensor(scale, dtype=torch.float32))
    want = tref.bp_quantize_ref(x.float(), s)
    assert torch.equal(_counted_codes(x, s), want)
    assert torch.equal(tbpm.bp_quantize(x, s.reshape(1, 1)), want)


@pytest.mark.parametrize("scale", SCALES)
def test_boundary_count_quantises_f32(scale, rng):
    x = torch.from_numpy(_boundary_values(rng, scale))
    s = torch.tensor(scale, dtype=torch.float32)
    assert torch.equal(_counted_codes(x, s), tref.bp_quantize_ref(x, s))


# ---------------------------------------------------------------------------
# codes matmul: the table encode and the f32 split-K sums
# ---------------------------------------------------------------------------

def _code_table(which):
    """(19, 8) plane bytes of the codes -9..9: sign(c) * (|c| >= t_p)."""
    c = torch.arange(-9, 10)
    t = torch.tensor(plane_thresholds(which))
    return (c.abs()[:, None] >= t).to(torch.int64) * c.sign()[:, None]


@pytest.mark.parametrize("m,k,n,splits", [(5, 300, 7, 6), (16, 2560, 9, 26),
                                          (3, 1, 4, 1), (4, 0, 3, 1),
                                          (2, 6912, 3, 6)])
def test_table_encode_and_f32_splits_equal_codes_matmul(m, k, n, splits, rng):
    xc = torch.from_numpy(rng.integers(-9, 10, (m, k), dtype=np.int8))
    yc = torch.from_numpy(rng.integers(-9, 10, (k, n), dtype=np.int8))
    if k:
        xc[0] = 9                    # the largest sums: 8 a k
        yc[:, 0] = 9
    xp = _code_table("right")[xc.long() + 9]          # (M, K, 8)
    yp = _code_table("left")[yc.long() + 9]           # (K, N, 8)
    step = -(-k // splits) if k else 1
    parts = [torch.einsum("mkp,knp->mn", xp[:, k0:k0 + step],
                          yp[k0:k0 + step]) for k0 in range(0, k, step)]
    assert all(int(p.abs().max()) < 2 ** 24 for p in parts)
    out = torch.zeros((m, n), dtype=torch.float32)
    for i in rng.permutation(len(parts)):          # atomics: any order
        out += parts[i].to(torch.float32)
    want = tref.bp_matmul_ref(xc, yc)
    assert torch.equal(out, want)
    if k:
        assert float(want[0, 0]) == 8.0 * k


# ---------------------------------------------------------------------------
# decode attention: the split schedule
# ---------------------------------------------------------------------------

def _attn(rng, b=3, s=100, kh=2, g=4, d=16):
    q = (rng.normal(size=(b, kh, g, d)) / np.sqrt(d)).astype(np.float32)
    kc, ks = jattn.quantize_kv(jnp.asarray(
        rng.normal(size=(b, s, kh, d)).astype(np.float32)))
    vc, vs = jattn.quantize_kv(jnp.asarray(
        rng.normal(size=(b, s, kh, d)).astype(np.float32)))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    qp = np.full((b,), s - 1, np.int32)
    return [q, np.array(kc), np.array(ks), np.array(vc), np.array(vs), pos,
            qp]


def _check(arrs, window, softcap, split, chunk=None):
    t = list(map(torch.from_numpy, arrs))
    got = tattn.bp8_decode_attention_split_ref(*t, window, softcap=softcap,
                                               split=split).numpy()
    plain = tattn.bp8_decode_attention_ref(*t, window,
                                           softcap=softcap).numpy()
    s = arrs[1].shape[1]
    want = np.array(jattn.bp8_decode_attention(
        *map(jnp.asarray, arrs), window, softcap=softcap,
        chunk=chunk or s, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    return got


@pytest.mark.parametrize("case", ["ragged", "masked_split", "dead_row",
                                  "window_cuts_splits", "softcap",
                                  "g8_d128"])
def test_split_schedule_matches_reference(case, rng):
    window, softcap, split = None, None, 32
    if case == "ragged":                     # 100 = 3 x 32 + 4
        arrs = _attn(rng, s=100)
    elif case == "masked_split":             # tokens 32..63 empty
        arrs = _attn(rng, s=128)
        arrs[5][:, 32:64] = -1
    elif case == "dead_row":                 # every split fully masked
        arrs = _attn(rng, s=100)
        arrs[5][-1] = -1
    elif case == "window_cuts_splits":       # only the last split is live
        arrs = _attn(rng, s=160)
        window = 20
    elif case == "softcap":
        arrs = _attn(rng, s=96)
        softcap = 30.0
        split = 64
    else:
        arrs = _attn(rng, b=2, s=70, g=8, d=128)
    got = _check(arrs, window, softcap, split)
    if case == "dead_row":
        v = tattn.dequantize_kv(torch.from_numpy(arrs[3]),
                                torch.from_numpy(arrs[4])).numpy()
        np.testing.assert_allclose(got[-1], np.repeat(
            v[-1].mean(0)[:, None], 4, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("s,rows,g,d", [(1024, 32, 4, 80), (1, 4, 4, 80),
                                        (33, 64, 8, 128), (4096, 32, 8, 128),
                                        (100000, 2, 4, 256), (70, 1, 16, 64)])
def test_split_tokens_gives_live_splits_that_fit(s, rows, g, d):
    split = tattn.split_tokens(s, rows, g, d)
    assert split in (32, 64, 128) and split <= tattn.SPLIT_MAX
    n = math.ceil(s / split)
    assert (n - 1) * split < s                       # no empty split
    assert split == 32 or tattn._split_smem(g, d, split) <= tattn.SPLIT_SMEM
    if (s, rows) == (1024, 32):
        assert (split, n * rows) == (64, 512)        # fills 132 SMs ~4x


# ---------------------------------------------------------------------------
# popcount: the lane-to-row schedule
# ---------------------------------------------------------------------------

POPCOUNT_UNROLL = 4              # csrc/popcount.cu kUnroll


def _lane_reads(c, misalign, lanes):
    """Byte indices each of a row's ``lanes`` lanes reads, as the kernel's
    loops take them: (lanes, n) arrays of indices and of validity."""
    sub = np.arange(lanes)[:, None]
    head = min(c, (16 - misalign) & 15)
    nvec = (c - head) >> 4
    hidx = sub + lanes * np.arange(-(-16 // lanes))
    hok = hidx < head
    step = POPCOUNT_UNROLL * lanes
    i0 = sub + step * np.arange(max(-(-nvec // step), 1))        # (L, n0)
    vi = i0[:, :, None] + lanes * np.arange(POPCOUNT_UNROLL)     # (L, n0, U)
    vok = (i0[:, :, None] < nvec) & (vi < nvec)
    vidx = head + 16 * vi[..., None] + np.arange(16)             # (.., 16)
    vok = np.broadcast_to(vok[..., None], vidx.shape)
    tidx = head + 16 * nvec + sub + lanes * np.arange(-(-16 // lanes))
    tok = tidx < c
    idx = np.concatenate([hidx, vidx.reshape(lanes, -1), tidx], axis=1)
    ok = np.concatenate([hok, vok.reshape(lanes, -1), tok], axis=1)
    return idx, ok


def _popcount_warp_emulated(rows, misaligns, lanes):
    """One warp: ``32 / lanes`` rows (byte arrays), lane sums, then the
    segmented xor butterfly; returns each row's sum from its first lane
    and how many times each byte of each row was read."""
    acc = np.zeros(32, np.int64)
    reads = []
    for slot, (row, mis) in enumerate(zip(rows, misaligns)):
        idx, ok = _lane_reads(row.size, mis, lanes)
        cnt = np.zeros(row.size, np.int64)
        np.add.at(cnt, idx[ok], 1)
        reads.append(cnt)
        vals = np.where(ok, row[np.where(ok, idx, 0)].astype(np.int64), 0)
        acc[slot * lanes:(slot + 1) * lanes] = vals.sum(axis=1)
    o = lanes // 2
    while o:
        acc = acc + acc[np.arange(32) ^ o]
        o //= 2
    return acc[::lanes][:len(rows)], reads


@pytest.mark.parametrize("c0", range(1, 4097, 512))
def test_popcount_schedule_reads_each_byte_once_and_sums(c0):
    """Widths c0..c0+511, a warp of rows each, the tile starting at every
    misalignment 0..15 (row r then starts at (m + r * C) % 16)."""
    rng = np.random.default_rng(c0)
    for c in range(c0, c0 + 512):
        lanes = tbpm.popcount_lanes(c)
        assert lanes in (1, 2, 4, 8, 16, 32)
        n = 32 // lanes
        tile = rng.integers(-128, 128, (n, c), dtype=np.int8)
        want = tref.popcount_accumulate_ref(torch.from_numpy(tile)).numpy()
        for m in range(16):
            got, reads = _popcount_warp_emulated(
                tile, [(m + r * c) % 16 for r in range(n)], lanes)
            assert all((r == 1).all() for r in reads), (c, m)
            np.testing.assert_array_equal(got, want, err_msg=f"C {c} m {m}")


@pytest.mark.parametrize("c,lanes", [(1, 1), (16, 1), (31, 1), (32, 2),
                                     (64, 4), (256, 16), (511, 16),
                                     (512, 32), (2048, 32), (4096, 32)])
def test_popcount_lanes_one_load_a_lane(c, lanes):
    """A row of C bytes gets C / 16 lanes (one 16-byte load each), as a
    power of two in 1..32: 16, 64 and 256 columns (the paper's adder
    trees) take 1, 4 and 16 lanes, 2048 a whole warp."""
    assert tbpm.popcount_lanes(c) == lanes
