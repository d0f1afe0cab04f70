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
input gives bitwise what its f32 cast gives.  NaN and Inf inputs give NaN
where the plain version does and its values elsewhere.  Popcount is exact
at the periphery's widths (16, 64, 256) and 2048, in one launch, and on
ragged rows at every misalignment.  The paged engine's entry points,
replayed from CUDA graphs, give the eager calls' logits and caches
bitwise, and the capturing engine the eager engine's tokens; so does the
lock-step engine's decode.  Sampling on the card draws the CPU's bits and
uniforms bitwise and its tokens.  The kernel counters count eager calls
only.
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


#: CUDA API calls that enqueue device work (a kernel, a memset, a copy)
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")


def _kernels_enqueued(fn) -> dict:
    """Device work (kernels and memsets) one call of ``fn`` enqueues, by
    the CUDA API call that enqueued it, from the profiler (after one call
    to warm up); each count is the larger of two profiled calls.  The
    launches are counted where the host makes them: the profiler's record
    of the kernel itself is lost now and then (a session in which CUPTI
    requests a new activity buffer keeps the launch and drops the
    kernel), the record of the launch never."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.key in ENQUEUE_CALLS:
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


# ---------------------------------------------------------------------------
# NaN and Inf: the card gives NaN where the plain version (and the
# reference) does, and the plain version's bits everywhere else
# ---------------------------------------------------------------------------

SPECIALS = {"nan": (float("nan"),), "inf": (float("inf"),),
            "neg_inf": (-float("inf"),),
            "nan_and_inf": (float("nan"), float("inf"))}


def _with_special(x, special, at):
    x = x.clone()
    flat = x.view(-1)
    for j, v in enumerate(SPECIALS[special]):
        flat[(at + 3 * j) % flat.numel()] = v
    return x


def _assert_nan_and_bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


@pytest.mark.gpu
@pytest.mark.parametrize("special", list(SPECIALS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [7, 4097, 1 << 22])
def test_absmax_nan_and_inf(size, dtype, special, cuda, rng):
    """The special value first, in the middle and last, in an aligned
    tensor and in an unaligned view (scalar head and tail)."""
    base = _randn(rng, (size + 1,), cuda).to(dtype)
    for x in (base[:size], base[1:]):
        for at in (0, size // 2, size - 1):
            t = _with_special(x, special, at)
            for floor in (0.0, TINY):
                got = tfused.absmax(t, floor)
                want = tref.absmax_ref(t, floor)
                _assert_nan_and_bits_equal(got, want)
                assert bool(torch.isnan(got).all()) == special.startswith(
                    "nan")


@pytest.mark.gpu
@pytest.mark.parametrize("special", list(SPECIALS))
@pytest.mark.parametrize("m,k,n", [(4, 2560, 640), (130, 100, 96)])
def test_fused_matmul_nan_and_inf(m, k, n, special, cuda, rng):
    x, y = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    for xs, ys in ((_with_special(x, special, 5), y),
                   (x, _with_special(y, special, 5))):
        for w in (ys, ys.to(torch.bfloat16)):
            got = tops.oisma_matmul(xs, w)
            _assert_nan_and_bits_equal(got, tref.fused_matmul_ref(xs, w))
            assert bool(torch.isnan(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("special", list(SPECIALS))
def test_fused_mlp_nan_and_inf_in_x(special, act, cuda, rng):
    m, k, f = 4, 2560, 6912
    x = _with_special(_randn(rng, (m, k), cuda), special, 11)
    up, gate = (_randn(rng, (k, f), cuda, k ** -0.5).to(torch.bfloat16)
                for _ in range(2))
    got = tops.oisma_mlp(x, up, gate, act=act)
    want = tref.fused_mlp_ref(x, up, gate, act)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,f", [(4, 2560, 6912), (130, 100, 96)])
def test_fused_mlp_relu_keeps_a_nan_in_w_gate(m, k, f, wdtype, cuda, rng):
    x = _randn(rng, (m, k), cuda)
    up = _randn(rng, (k, f), cuda).to(wdtype)
    gate = _with_special(_randn(rng, (k, f), cuda), "nan", 17).to(wdtype)
    got = tops.oisma_mlp(x, up, gate, act="relu")
    _assert_nan_and_bits_equal(got, tref.fused_mlp_ref(x, up, gate, "relu"))
    assert bool(torch.isnan(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("s", [48, 1024])
def test_decode_attention_nan_in_q(s, cuda, rng):
    """A NaN in one query head gives NaN in that head's output only, as
    the plain version; every other value within 1e-5."""
    b, kh, g, d = 3, 8, 4, 80
    q = _randn(rng, (b, kh, g, d), cuda, 1.0) / d ** 0.5
    q[1, 2, 3, 7] = float("nan")
    kc, ks = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    vc, vs = tattn.quantize_kv(_randn(rng, (b, s, kh, d), cuda, 1.0))
    pos = torch.arange(s, dtype=torch.int32, device=cuda).repeat(b, 1)
    pos[0, s // 2:] = -1
    qp = torch.full((b,), s - 1, dtype=torch.int32, device=cuda)
    args = (q, kc, ks, vc, vs, pos, qp, None)
    got = tattn.bp8_decode_attention(*args)
    want = tattn.bp8_decode_attention_ref(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(want[1, 2, 3]).all())
    ok = ~torch.isnan(want)
    torch.testing.assert_close(got[ok], want[ok], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# popcount: the paper's periphery widths and ragged rows, in one launch
# ---------------------------------------------------------------------------

#: 8 MB tiles at the periphery's widths (16, 64, 256) and at 2048
POPCOUNT_WIDTHS = [(524288, 16), (131072, 64), (32768, 256), (4096, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("r,c", POPCOUNT_WIDTHS)
def test_popcount_widths_exact(r, c, cuda, rng):
    bits = torch.from_numpy(rng.integers(0, 2, (r, c), dtype=np.int8)).to(
        cuda)
    for t in (bits, torch.from_numpy(rng.integers(
            -128, 128, (r, c), dtype=np.int8)).to(cuda)):
        for u in (t, t.to(torch.uint8), t > 0):
            assert torch.equal(tbpm.popcount_accumulate(u),
                               tref.popcount_accumulate_ref(u))
    seen = _kernels_enqueued(lambda: tbpm.popcount_accumulate(bits))
    assert sum(seen.values()) == 1, seen


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 15, 16, 17, 31, 33, 63, 100, 255, 257,
                               511, 1000, 2047, 4100])
def test_popcount_ragged_rows_every_misalignment(c, cuda, rng):
    """Rows of every width class, the tile starting at every offset 0..15
    from a 16-byte boundary (so rows start misaligned in every way)."""
    r = 77
    flat = torch.from_numpy(rng.integers(-128, 128, r * c + 16,
                                         dtype=np.int8)).to(cuda)
    for buf in (flat, flat.view(torch.uint8), flat > 0):
        for off in range(16):
            t = buf[off:off + r * c].view(r, c)
            assert torch.equal(tbpm.popcount_accumulate(t),
                               tref.popcount_accumulate_ref(t))


# ---------------------------------------------------------------------------
# CUDA graphs of the paged engine's entry points
# ---------------------------------------------------------------------------

def _smoke(arch="h2o_danube_1p8b"):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               matmul_mode="bp8_fused", kv_quant="bp8")


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _trees_equal(a, b):
    from repro_torch.models.params import tree_leaves
    return all(torch.equal(x, y) for (_, x), (_, y)
               in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen2_72b"])
def test_replayed_entry_points_bitwise_equal_eager(arch, cuda, rng):
    """A prefill chunk and a decode step, replayed from their graphs, give
    bitwise the eager call's logits and cache, and a second replay on new
    inputs as well."""
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.serve.graphs import GraphedEntry
    cfg = _smoke(arch)
    model = build(cfg)
    params = init_params(model.schema(), seed=0, device=cuda)
    pool = torch.cuda.graph_pool_handle()
    prefill = GraphedEntry(lambda t, v, p0: model.prefill_chunk(
        params, {"tokens": t}, v, p0), capture=True, pool=pool)
    decode = GraphedEntry(lambda t, v, p: model.decode_step(params, t, v, p),
                          capture=True, pool=pool)
    cache = model.init_cache(1, 32, cuda)
    tok, view, pos0 = prefill.inputs("p", lambda: (
        torch.empty((1, 8), dtype=torch.int64, device=cuda), _clone(cache),
        torch.empty((), dtype=torch.int64, device=cuda)))
    for p0 in (0, 8):
        t = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 8))).to(cuda)
        eager_cache = _clone(cache)
        want, eager_cache = model.prefill_chunk(params, {"tokens": t},
                                                eager_cache, p0)
        tok.copy_(t)
        pos0.fill_(p0)
        for leaf, src in zip(view["layers"].values(),
                             cache["layers"].values()):
            leaf.copy_(src)
        got, got_cache = prefill("p")
        assert torch.equal(got, want), (got - want).abs().max()
        assert _trees_equal(got_cache, eager_cache)
        cache = eager_cache
    assert prefill.count == 1
    rows = 4
    full = {"layers": {k: v.expand(-1, rows, *v.shape[2:]).contiguous()
                       for k, v in cache["layers"].items()}}
    tok, view, pos = decode.inputs(32, lambda: (
        torch.empty((rows, 1), dtype=torch.int64, device=cuda),
        _clone(full), torch.empty((rows,), dtype=torch.int32, device=cuda)))
    for step in range(2):
        t = torch.from_numpy(rng.integers(2, cfg.vocab_size, (rows, 1))).to(
            cuda)
        p = torch.tensor([16 + step, 20, 16, 31], dtype=torch.int32,
                         device=cuda)
        want, eager_cache = model.decode_step(params, t, _clone(full), p)
        tok.copy_(t)
        pos.copy_(p)
        for leaf, src in zip(view["layers"].values(),
                             full["layers"].values()):
            leaf.copy_(src)
        got, got_cache = decode(32)
        assert torch.equal(got, want), (got - want).abs().max()
        assert _trees_equal(got_cache, eager_cache)
    assert decode.count == 1


@pytest.mark.gpu
def test_captured_engine_tokens_equal_eager(cuda, rng):
    """The engine's graphs emit the eager engine's tokens, capture each
    shape once, and stay within the reference's bounds."""
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.serve.paged_engine import (PagedEngineConfig,
                                                PagedRequest,
                                                PagedServeEngine)
    cfg = _smoke()
    model = build(cfg)
    params = init_params(model.schema(), seed=0, device=cuda)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 9, 30)]
    ecfg = PagedEngineConfig(slots=2, block_size=8, num_blocks=32,
                             max_prefill_tokens=8)
    out = {}
    for capture in (None, False):
        eng = PagedServeEngine(model, params, cfg, ecfg, device=cuda,
                               capture=capture)
        reqs = [PagedRequest(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        out[capture] = eng.run(reqs)
        counts, bounds = eng.compile_counts(), eng.compile_shape_bounds()
        assert all(0 < counts[k] <= bounds[k] for k in bounds), counts
        snap = eng.stats.snapshot()
        assert counts == {"prefill_chunk": snap["prefill_shape_count"],
                          "decode_step": snap["decode_shape_count"]}
        assert (snap["capture_s"] > 0) == (capture is None)
    assert out[None] == out[False]


@pytest.mark.gpu
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("vocab", [7, 32000])
def test_card_sampling_equals_cpu(vocab, partitionable, cuda, rng):
    """Threefry keys, random bits and uniforms on the card are bitwise the
    CPU's; the tokens are equal at T 0.5, 0.8 and 1.0 (the gumbel noise may
    differ in the last bit of ``log``)."""
    from repro_torch.serve import sampling as S
    rows = [(rid, step) for rid in range(6) for step in range(8)]
    for seed in range(4):
        keys = S.row_keys(seed, rows, "cpu")
        assert torch.equal(S.row_keys(seed, rows, cuda).cpu(), keys)
        bits = S.random_bits(keys, vocab, partitionable)
        cbits = S.random_bits(keys.to(cuda), vocab, partitionable)
        assert torch.equal(cbits.cpu(), bits)
        assert torch.equal(S.uniform(cbits).cpu(), S.uniform(bits))
        logits = torch.from_numpy((rng.normal(size=(len(rows), vocab)) * 3)
                                  .astype(np.float32))
        for t in (0.5, 0.8, 1.0):
            kw = dict(seed=seed, temperature=t, partitionable=partitionable)
            np.testing.assert_array_equal(
                S.sample_tokens(logits.to(cuda), rows, **kw),
                S.sample_tokens(logits, rows, **kw))


@pytest.mark.gpu
def test_lockstep_replayed_decode_bitwise_equal_eager(cuda, rng):
    """The lock-step engine's decode, replayed from its graph over the
    engine's contiguous cache with one scalar position, gives the eager
    call's logits and cache bitwise; a capturing and an eager engine emit
    the same tokens (greedy and T 0.8), one graph for each (slots,
    max_len) it meets.
    """
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    cfg = _smoke()
    model = build(cfg)
    params = init_params(model.schema(), seed=0, device=cuda)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 9, 30)]
    for temperature in (0.0, 0.8):
        out = {}
        for capture in (True, False):
            eng = ServeEngine(model, params, cfg,
                              EngineConfig(slots=2, max_len=64,
                                           temperature=temperature),
                              device=cuda, capture=capture)
            out[capture] = eng.run([Request(rid=i, prompt=p,
                                            max_new_tokens=6)
                                    for i, p in enumerate(prompts)], seed=3)
            # two generations: requests 0-2 on 2 rows, then the deferred
            # 30-token prompt alone
            assert eng.compile_counts() == {"decode_step": 2}
        assert out[True] == out[False]
    eng = ServeEngine(model, params, cfg, EngineConfig(slots=2, max_len=64),
                      device=cuda, capture=True)
    eng.run([Request(rid=0, prompt=prompts[0], max_new_tokens=2)])
    with torch.inference_mode():        # the engine's buffers are made so
        _lockstep_replays(eng, model, params, prompts[3], cuda, rng)
    assert eng.compile_counts() == {"decode_step": 1}


def _lockstep_replays(eng, model, params, prompt, cuda, rng):
    tok, cache, pos = eng._decode_inputs(1)          # its captured shape
    _, fresh = model.prefill(params, {"tokens": torch.from_numpy(
        prompt[None].astype(np.int64)).to(cuda)}, 64)
    for step in range(3):
        t = torch.from_numpy(rng.integers(2, model.cfg.vocab_size,
                                          (1, 1))).to(cuda)
        p = torch.tensor(30 + step, dtype=torch.int32, device=cuda)
        want, want_cache = model.decode_step(params, t, _clone(fresh), p)
        tok.copy_(t)
        pos.copy_(p)
        for leaf, src in zip(cache["layers"].values(),
                             fresh["layers"].values()):
            leaf.copy_(src)
        got, got_cache = eng._decode((1, 64))
        assert torch.equal(got, want), (got - want).abs().max()
        assert _trees_equal(got_cache, want_cache)
        fresh = want_cache


@pytest.mark.gpu
def test_record_counts_eager_calls_only(cuda, rng):
    """``kernels.calls`` counts eager calls; a capture records nothing and
    a replay calls no op."""
    from repro_torch.kernels import metrics
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    prev = metrics.set_registry(reg)
    try:
        x = _randn(rng, (4, 256), cuda)
        w = _randn(rng, (256, 128), cuda).to(torch.bfloat16)
        tops.oisma_matmul(x, w)                       # eager: counted
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tops.oisma_matmul(x, w)
        assert reg.value("kernels.calls", kernel="fused_matmul") == 1
        graph.replay()
        torch.cuda.synchronize()
        assert reg.value("kernels.calls", kernel="fused_matmul") == 1
        assert torch.equal(out, tops.oisma_matmul(x, w))
        assert reg.value("kernels.calls", kernel="fused_matmul") == 2
    finally:
        metrics.set_registry(prev)
