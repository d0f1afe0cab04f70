"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a card they skip.  The file imports neither jax
nor the reference package, so it runs on a machine that has only torch
and nvcc:

    python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerances: absmax (f32 and bf16, with and without its floor) and the
fused matmul (f32, bf16 and int8-coded y) bitwise; the fused MLP 1e-5 for
silu and gelu (expf/tanhf and their contraction into FMAs may differ in
the last bits) and bitwise for relu; decode attention 1e-5 (the softmax
reassociated over chunks or splits); the unfused pipeline's kernels
(codes matmul, BP quantise on f32 and bf16, popcount) bitwise, and
``impl="unfused"`` bitwise equal to ``impl="fused"``.  A bf16 weight or
input gives bitwise what its f32 cast gives.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as tattn  # noqa: E402
from repro_torch.kernels import bp_matmul as tbpm  # noqa: E402
from repro_torch.kernels import fused as tfused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHAPES = [(130, 100, 96), (16, 128, 128), (1, 7, 5), (129, 257, 130),
          (4, 2560, 640), (64, 640, 260)]
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=2.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).to(dev)


def _kernels_enqueued(fn) -> dict:
    """Device activities (kernels and memsets) one call of ``fn``
    enqueues, by name, from the profiler (after one call to warm up).
    Each name's count is the larger of two profiled calls: a profiling
    session can miss the first activities it should record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                seen[e.key] = max(seen.get(e.key, 0), e.count)
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bp_kernels_match_plain(m, k, n, cuda, rng):
    x, y = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    assert torch.equal(tfused.absmax(y), tref.absmax_ref(y))
    got = tops.oisma_matmul(x, y)
    assert torch.equal(got, tref.fused_matmul_ref(x, y))
    codes, scale = tops.prepare_bp_weight(y)
    assert torch.equal(tops.oisma_matmul(x, codes, y_scale=scale), got)
    for act in ("silu", "gelu", "relu"):
        torch.testing.assert_close(tops.oisma_mlp(x, y, y, act=act),
                                   tref.fused_mlp_ref(x, y, y, act),
                                   rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, None), (17, 30.0)])
@pytest.mark.parametrize("s,d", [(64, 16), (48, 80), (1024, 80)])
def test_decode_attention_matches_plain(s, d, window, softcap, cuda, rng):
    b, kh, g = 3, 2, 4
    q = _randn(rng, (b, kh, g, d), cuda, 1.0) / d ** 0.5
    kc, ks = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    vc, vs = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    pos = torch.arange(s, dtype=torch.int32, device=cuda).repeat(b, 1)
    pos[0, s - 7:] = -1                       # empty tail
    pos[-1] = -1                              # an all-masked row
    qp = torch.tensor([s - 8, s - 1, s - 1], dtype=torch.int32, device=cuda)
    args = (q, kc, ks, vc, vs, pos, qp, window)
    torch.testing.assert_close(
        tattn.bp8_decode_attention(*args, softcap=softcap),
        tattn.bp8_decode_attention_ref(*args, softcap=softcap),
        rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_unfused_kernels_match_plain(m, k, n, cuda, rng):
    def codes(shape):
        return torch.from_numpy(rng.integers(-9, 10, shape, dtype=np.int8)
                                ).to(cuda)

    xc, yc = codes((m, k)), codes((k, n))
    assert torch.equal(tbpm.bp_matmul(xc, yc), tref.bp_matmul_ref(xc, yc))
    x, y = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    s = tref.tensor_scale(x)
    assert torch.equal(tbpm.bp_quantize(x, s), tref.bp_quantize_ref(x, s))
    for bits in (codes((m, k)), codes((m, k)).to(torch.uint8),
                 codes((m, k)) > 0):
        assert torch.equal(tbpm.popcount_accumulate(bits),
                           tref.popcount_accumulate_ref(bits))
    assert torch.equal(tops.oisma_matmul(x, y, impl="unfused"),
                       tops.oisma_matmul(x, y))


@pytest.mark.gpu
def test_bp_quantize_half_level_boundaries(cuda):
    s = torch.tensor([[5.128217]], device=cuda)
    mid = (torch.arange(9, device=cuda) + 0.5) * s[0, 0] / 10
    x = torch.cat([mid, torch.nextafter(mid, mid + 1),
                   torch.nextafter(mid, mid - 1)])
    x = torch.cat([x, -x, torch.tensor([4.358984, 0.0], device=cuda)])
    assert torch.equal(tbpm.bp_quantize(x, s), tref.bp_quantize_ref(x, s))


def _codes(rng, shape, dev):
    return torch.from_numpy(rng.integers(-9, 10, shape, dtype=np.int8)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(m, 2560, 640) for m in (1, 4, 16, 64,
                                                             256)]
                         + [(130, 100, 96), (1, 7, 5), (100, 300, 130),
                            (129, 257, 130), (256, 6912, 40), (3, 0, 4),
                            (200, 0, 130)])
def test_codes_matmul_rows_bitwise(m, k, n, cuda, rng):
    """Every row-block instance (16, 64 and the 128-row wgmma one), ragged
    rows, columns and K (the element-by-element loaders), a K split, and
    K = 0 (the sums are zero)."""
    xc, yc = _codes(rng, (m, k), cuda), _codes(rng, (k, n), cuda)
    got = tbpm.bp_matmul(xc, yc)
    assert torch.equal(got, tref.bp_matmul_ref(xc, yc))
    assert torch.equal(got, tbpm.bp_matmul(xc, yc))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2560, 2560), (64, 2560, 640),
                                   (256, 2560, 6912), (1, 7, 5), (3, 0, 4)])
def test_codes_matmul_at_most_two_launches(m, k, n, cuda, rng):
    xc, yc = _codes(rng, (m, k), cuda), _codes(rng, (k, n), cuda)
    seen = _kernels_enqueued(lambda: tbpm.bp_matmul(xc, yc))
    assert 1 <= sum(seen.values()) <= 2, seen


def _all_bf16(dev):
    """Every finite bf16 bit pattern."""
    v = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    v = v.view(torch.bfloat16)
    return v[torch.isfinite(v)].to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [5.128217, 0.37, 1.1754944e-38, 3e38,
                                   "max"])
def test_bp_quantize_bf16_every_pattern(scale, cuda):
    """A bf16 x is quantised by its f32 value: every finite pattern,
    aligned and one element off (element by element), equals the plain
    version of the f32 cast."""
    x = _all_bf16(cuda)
    if scale == "max":
        s = tref.tensor_scale(x.float())
    else:
        s = torch.full((1, 1), scale, device=cuda)
    for t in (x, x[1:]):
        want = tref.bp_quantize_ref(t.float(), s)
        assert torch.equal(tbpm.bp_quantize(t, s), want)
        assert torch.equal(tbpm.bp_quantize(t.float(), s), want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 2560), (2560, 6912), (7,), (33, 70)],
                         ids=str)
def test_bp_quantize_bf16_matches_plain(shape, cuda, rng):
    x = _randn(rng, shape, cuda).to(torch.bfloat16)
    s = tref.tensor_scale(x.float())
    got = tbpm.bp_quantize(x, s)
    assert torch.equal(got, tref.bp_quantize_ref(x.float(), s))
    assert torch.equal(got, tbpm.bp_quantize(x.float(), s))
    seen = _kernels_enqueued(lambda: tbpm.bp_quantize(x, s))
    assert sum(seen.values()) == 1, seen


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2560, 640), (256, 2560, 2560),
                                   (130, 100, 96), (3, 33, 50)])
def test_unfused_bf16_weight_bitwise(m, k, n, cuda, rng):
    """impl="unfused" reads a bf16 weight as stored: bitwise the fused
    path's result and that of the f32 cast."""
    x = _randn(rng, (m, k), cuda, 1.0)
    y = _randn(rng, (k, n), cuda, k ** -0.5).to(torch.bfloat16)
    got = tops.oisma_matmul(x, y, impl="unfused")
    assert torch.equal(got, tops.oisma_matmul(x, y))
    assert torch.equal(got, tops.oisma_matmul(x, y.float(), impl="unfused"))


@pytest.mark.gpu
def test_empty_contraction_gives_zeros(cuda):
    x = torch.zeros((3, 0), dtype=torch.int8, device=cuda)
    y = torch.zeros((0, 4), dtype=torch.int8, device=cuda)
    assert torch.equal(tbpm.bp_matmul(x, y),
                       torch.zeros((3, 4), device=cuda))


@pytest.mark.gpu
def test_popcount_rejects_wide_types(cuda):
    with pytest.raises(TypeError, match="int8"):
        tbpm.popcount_accumulate(torch.ones((4, 8), dtype=torch.int32,
                                            device=cuda))


def _boundary_values(rng, scale, shape, dev):
    """Values on the plane boundaries of ``scale`` and one ulp either side,
    with random signs, tiled to ``shape``."""
    b = tref.level_boundaries(scale.cpu())
    inf = torch.full_like(b, torch.inf)
    vals = torch.cat([b, torch.nextafter(b, inf), torch.nextafter(b, -inf),
                      torch.tensor([0.0, float(scale)])])
    idx = torch.from_numpy(rng.integers(0, len(vals), shape))
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], shape).astype(np.float32))
    return (vals[idx] * sign).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8, 16, 64, 65, 256])
def test_fused_matmul_rows_bitwise(m, cuda, rng):
    k, n = 640, 384
    x, y = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    sx, sy = tref.tensor_scale(x), tref.tensor_scale(y)
    got = tfused.fused_bp_matmul(x, y, sx, sy)
    assert torch.equal(got, tref.fused_matmul_ref(x, y, sx, sy))
    codes, cs = tops.prepare_bp_weight(y)
    assert torch.equal(tfused.fused_bp_matmul(x, codes, sx, cs),
                       tref.fused_matmul_ref(x, codes, sx, cs))


@pytest.mark.gpu
@pytest.mark.parametrize("coded", [False, True], ids=["real_y", "coded_y"])
@pytest.mark.parametrize("m,k,n", [(130, 100, 96), (1, 7, 5), (4, 2560, 640),
                                   (3, 33, 50)])
def test_fused_matmul_ragged_bitwise(m, k, n, coded, cuda, rng):
    x, y = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    sx, sy = tref.tensor_scale(x), tref.tensor_scale(y)
    if coded:
        y, sy = tops.prepare_bp_weight(y)
    assert torch.equal(tfused.fused_bp_matmul(x, y, sx, sy),
                       tref.fused_matmul_ref(x, y, sx, sy))


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [5.128217, 0.37, 1.1754944e-38, 3e38])
def test_fused_matmul_on_plane_boundaries(scale, cuda, rng):
    """Operands placed exactly on the encode's boundaries and one ulp
    either side (x at ``scale``, y at scale 1, so sx * sy stays finite):
    the comparison encode gives the division's levels."""
    sx = torch.tensor([[scale]], dtype=torch.float32, device=cuda)
    sy = torch.ones((1, 1), device=cuda)
    x = _boundary_values(rng, sx, (8, 96), cuda)
    y = _boundary_values(rng, sy, (96, 136), cuda)
    for xx in (x, torch.cat([x] * 9)):          # M 8 and 72
        assert torch.equal(tfused.fused_bp_matmul(xx, y, sx, sy),
                           tref.fused_matmul_ref(xx, y, sx, sy))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2560, 2560), (64, 2560, 2560),
                                   (256, 2560, 6912), (1, 7, 5)])
def test_fused_matmul_at_most_two_launches(m, k, n, cuda, rng):
    x, y = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    sx, sy = tref.tensor_scale(x), tref.tensor_scale(y)
    for w in (y, y.to(torch.bfloat16)):
        seen = _kernels_enqueued(lambda: tfused.fused_bp_matmul(x, w, sx, sy))
        assert 1 <= sum(seen.values()) <= 2, seen


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2560, 2560), (64, 2560, 640),
                                   (256, 640, 384), (130, 100, 96),
                                   (1, 7, 5), (3, 33, 50)])
def test_fused_matmul_bf16_weight_bitwise(m, k, n, cuda, rng):
    """A bf16 y, read as stored, gives bitwise what its f32 cast gives
    (N 50 takes the element-by-element loader)."""
    x = _randn(rng, (m, k), cuda, 1.0)
    y = _randn(rng, (k, n), cuda, k ** -0.5).to(torch.bfloat16)
    sx, sy = tref.tensor_scale(x), tref.tensor_scale(y)
    got = tfused.fused_bp_matmul(x, y, sx, sy)
    assert torch.equal(got, tfused.fused_bp_matmul(x, y.float(), sx, sy))
    assert torch.equal(got, tref.fused_matmul_ref(x, y, sx, sy))
    assert torch.equal(tops.oisma_matmul(x, y), tops.oisma_matmul(x, y.float()))


def _absmax_input(size, dtype, dev, rng):
    if size == "view":      # contiguous, but 1 element past an aligned start
        return _randn(rng, (4103,), dev).to(dtype)[1:4100]
    return _randn(rng, size, dev).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("floor", [0.0, TINY], ids=["no_floor", "tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [(1,), (7,), (4097,), (2560, 6912), "view"],
                         ids=str)
def test_absmax_bitwise(size, dtype, floor, cuda, rng):
    """Against the plain version, with the largest |x| at random, at the
    first element (the unaligned head) and at the last (the tail); two
    calls in a row agree (the library's block counter is reset)."""
    x = _absmax_input(size, getattr(torch, dtype), cuda, rng)
    flat = x.view(-1)
    for at, v in ((None, 0.0), (0, -1e3), (-1, 2e3)):
        if at is not None:
            flat[at] = v
        got = tfused.absmax(x, floor)
        assert torch.equal(got, tref.absmax_ref(x, floor))
        assert torch.equal(tfused.absmax(x, floor), got)
    zeros = torch.zeros_like(x)
    assert torch.equal(tfused.absmax(zeros, floor),
                       torch.full((1, 1), floor, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 2560), (2560, 6912), (7,)], ids=str)
def test_absmax_one_launch(shape, dtype, cuda, rng):
    x = _randn(rng, shape, cuda).to(getattr(torch, dtype))
    seen = _kernels_enqueued(lambda: tfused.absmax(x, TINY))
    assert sum(seen.values()) == 1, seen


def _mlp_weights(rng, k, f, kind, dev):
    """(up, gate, up scale, gate scale) of one kind: bf16, f32 or int8
    codes, from model-like values (std k**-0.5)."""
    out = []
    for _ in range(2):
        w = _randn(rng, (k, f), dev, k ** -0.5)
        if kind == "coded":
            out.append(tops.prepare_bp_weight(w))
        else:
            w = w.to(torch.bfloat16) if kind == "bf16" else w
            out.append((w, tref.tensor_scale(w)))
    (up, su), (gate, sg) = out
    return up, gate, su, sg


MLP_SHAPES = ([(m, 640, 384) for m in (1, 4, 8, 16, 64, 65, 256)]
              + [(130, 100, 96), (1, 7, 5)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "f32", "coded"])
@pytest.mark.parametrize("m,k,f", MLP_SHAPES)
def test_fused_mlp_matches_plain(m, k, f, kind, cuda, rng):
    x = _randn(rng, (m, k), cuda, 1.0)
    up, gate, su, sg = _mlp_weights(rng, k, f, kind, cuda)
    sx = tref.tensor_scale(x)
    for act in ("silu", "gelu", "relu"):
        got = tfused.fused_mlp(x, up, gate, sx, su, sg, act)
        want = tref.fused_mlp_ref(x, up, gate, act, sx, su, sg)
        if act == "relu":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        if kind == "bf16":
            assert torch.equal(got, tfused.fused_mlp(
                x, up.float(), gate.float(), sx, su, sg, act))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "f32", "coded"])
@pytest.mark.parametrize("m,k,f", [(4, 2560, 6912), (64, 2560, 6912),
                                   (256, 640, 384), (1, 7, 5)])
def test_fused_mlp_at_most_two_launches(m, k, f, kind, cuda, rng):
    x = _randn(rng, (m, k), cuda, 1.0)
    up, gate, su, sg = _mlp_weights(rng, k, f, kind, cuda)
    sx = tref.tensor_scale(x)
    seen = _kernels_enqueued(
        lambda: tfused.fused_mlp(x, up, gate, sx, su, sg, "silu"))
    assert 1 <= sum(seen.values()) <= 2, seen


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 33, 1024, 4096])
def test_decode_attention_cache_lengths(s, cuda, rng):
    b, kh, g, d = 4, 8, 4, 80
    q = _randn(rng, (b, kh, g, d), cuda, 1.0) / d ** 0.5
    kc, ks = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    vc, vs = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    pos = torch.arange(s, dtype=torch.int32, device=cuda).repeat(b, 1)
    pos[1, s // 2:] = -1                       # empty tail
    pos[-1] = -1                               # a dead row over every split
    qp = torch.full((b,), s - 1, dtype=torch.int32, device=cuda)
    for window, cap in ((None, None), (max(s // 3, 1), 30.0)):
        args = (q, kc, ks, vc, vs, pos, qp, window)
        got = tattn.bp8_decode_attention(*args, softcap=cap)
        torch.testing.assert_close(
            got, tattn.bp8_decode_attention_ref(*args, softcap=cap),
            rtol=0, atol=1e-5)
        uniform = tattn.dequantize_kv(vc, vs)[-1].mean(0)     # (KH, D)
        torch.testing.assert_close(got[-1], uniform[:, None].expand(kh, g, d),
                                   rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [100, 1024])
def test_decode_attention_wide_heads(s, cuda, rng):
    """D 128 with G 8 (qwen2-72b's heads)."""
    b, kh, g, d = 2, 8, 8, 128
    q = _randn(rng, (b, kh, g, d), cuda, 1.0) / d ** 0.5
    kc, ks = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    vc, vs = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    pos = torch.arange(s, dtype=torch.int32, device=cuda).repeat(b, 1)
    qp = torch.tensor([s - 1, s // 2], dtype=torch.int32, device=cuda)
    args = (q, kc, ks, vc, vs, pos, qp, None)
    torch.testing.assert_close(tattn.bp8_decode_attention(*args),
                               tattn.bp8_decode_attention_ref(*args),
                               rtol=0, atol=1e-5)
