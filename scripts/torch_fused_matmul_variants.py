"""Where the BP kernels' time goes on the card: time variants of the
integer core (``bp_mma.cuh``: the fused matmul, the fused MLP and the
codes matmul), of the BP quantise (``bp_quantize.cu``) and of popcount
(``popcount.cu``), each with one part cut out or done another way.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python scripts/torch_fused_matmul_variants.py [--only KIND] [variant ...]

Each variant is a copy of ``src/repro_torch/kernels/csrc/`` in which one
piece of a source is replaced (its results are then wrong; only the
variants in ``EXACT`` are checked bitwise against the plain versions),
built as the port builds its library into ``build/var_<name>/`` and timed
in a process of its own:

* ``main``: the kernels as they are;
* ``mmasync``: the codes matmul's 128-row instance on mma.sync instead of
  wgmma;
* ``cmpenc``: the codes matmul's codes encoded by comparison with the
  plane thresholds (``encode_val``), as a coded weight of the fused
  matmul is, instead of by the table;
* ``wgserial``: on wgmma, each step waits for its own products (no
  overlap of the next step's encode with them);
* ``noxenc``: no encode of x (f32 or codes; the plane tile keeps what it
  held);
* ``noyenc``: no encode of f32 and int8 weights;
* ``noyenc16``: no encode of bf16 weights;
* ``f32enc16``: bf16 weights widened to f32 and encoded a value at a time
  by f32 compares, as f32 weights are, instead of two values a compare;
* ``nomma``: no ldmatrix, mma or wgmma;
* ``noloop``: no k steps at all (launches, boundary search, first copies,
  epilogue);
* ``nobnd``: no boundary search in the matmuls;
* ``noepi``: no split-K epilogue (atomics, tile counter, last split);
* ``nosync``: no barrier between the encode and mma.sync;
* ``divq``: the quantise's level by the division, per element, instead
  of the count of boundaries;
* ``nobndq``: the quantise without its boundary search;
* ``earlierq``: the quantise's earlier design whole (f32 only): a
  division per element, one float4 a thread a grid-stride step;
* ``ldgq``: the quantise's loads without the streaming hint;
* ``stcsq``: the quantise's stores with the streaming hint;
* ``wideq``: the quantise with two units of 16 values a thread, not one;
* ``earlierp``: the popcount's earlier design whole: one warp a row,
  each lane's 16-byte loads one after another;
* ``popgrid``: the popcount's grid not capped at the SMs' resident
  blocks: one row group a warp, the blocks in waves;
* ``popldg``: the popcount's loads through the read-only path without
  the streaming hint.

The cases: the fused matmul on f32 weights at the shapes below, and on
bf16 weights (the served path's form) at two decode shapes; the MLP on
bf16 weights at decode (4 rows) and a prefill chunk (64 rows), and on f32
weights at decode; the codes matmul over one h2o-danube-1.8b layer at 256
rows (its 7 projections), at 4x2560x2560 and at qwen2-72b's
256x8192x29568; the quantise over one layer's 14 operands at 256 rows
with f32 weights and with bf16 weights; the popcount on 8 MB 0/1 tiles
of 16, 64, 256 and 2048 columns (also by the profiler's kernel time, and
beside ``bits.sum(-1, dtype=torch.int32)``).  ``--only KIND`` (mm, mlp,
codes, quant, pop) times one kind of case.  Times are CUDA events: ``cold``
the sum over the case's calls, each after a write of 64 MB (L2 flushed,
as ``chip_smoke.py`` times) and a device sleep that hides the host's
launch; ``warm`` the mean of 20 runs of the case back to back.  Every
line names the card it ran on.
"""
import concurrent.futures
import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MMA, QUANT, POP = "bp_mma.cuh", "bp_quantize.cu", "popcount.cu"
# The popcount's earlier design, whole: one warp a row, its lanes' 16-byte
# loads in a loop (the entry point ignores the lanes argument).
EARLIER_POPCOUNT = r"""#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <bool SIGNED>
__device__ __forceinline__ int add_bytes(uint32_t w, int acc) {
  if (SIGNED) return __dp4a((int)w, 0x01010101, acc);
  return (int)__dp4a(w, 0x01010101u, (unsigned)acc);
}

template <bool SIGNED>
__device__ __forceinline__ int byte_value(uint8_t b) {
  return SIGNED ? (int)(int8_t)b : (int)b;
}

template <bool SIGNED>
__global__ void __launch_bounds__(kThreads)
popcount_kernel(const uint8_t* __restrict__ bits, int* __restrict__ out,
                int R, int C) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const uint8_t* row = bits + (size_t)r * C;
  const int misalign = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(C, misalign ? 16 - misalign : 0);
  const int nvec = (C - head) / 16;
  const uint4* mid = reinterpret_cast<const uint4*>(row + head);
  int acc = 0;
  for (int i = lane; i < head; i += 32) acc += byte_value<SIGNED>(row[i]);
  for (int i = lane; i < nvec; i += 32) {
    const uint4 w = mid[i];
    acc = add_bytes<SIGNED>(w.x, acc);
    acc = add_bytes<SIGNED>(w.y, acc);
    acc = add_bytes<SIGNED>(w.z, acc);
    acc = add_bytes<SIGNED>(w.w, acc);
  }
  for (int i = head + 16 * nvec + lane; i < C; i += 32)
    acc += byte_value<SIGNED>(row[i]);
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[r] = acc;
}

}  // namespace

extern "C" int oisma_popcount(const uint8_t* bits, int is_signed, int* out,
                              int R, int C, int, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock);
  if (is_signed)
    popcount_kernel<true><<<blocks, kThreads, 0, stream>>>(bits, out, R, C);
  else
    popcount_kernel<false><<<blocks, kThreads, 0, stream>>>(bits, out, R, C);
  return (int)cudaGetLastError();
}
"""
# The quantise's earlier design, whole (f32 only: its entry point ignores
# x_kind): a division per element, one float4 a thread a grid-stride
# step, a char4 store, at most 8 blocks an SM.
EARLIER_QUANTIZE = r"""#include <cuda_runtime.h>
#include <stdint.h>
namespace {
__device__ __forceinline__ signed char bp_code(float v, float s) {
  const int l = (int)fminf(fmaxf(rintf(fabsf(v) / s * 10.0f), 0.0f), 9.0f);
  return (signed char)(v > 0.0f ? l : (v < 0.0f ? -l : 0));
}
__global__ void __launch_bounds__(256)
bp_quantize_kernel(const float* __restrict__ x, const float* __restrict__ s_p,
                   int8_t* __restrict__ out, long long n, bool vec) {
  const float s = *s_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* o4 = reinterpret_cast<char4*>(out);
    for (long long i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      o4[i] = make_char4(bp_code(v.x, s), bp_code(v.y, s), bp_code(v.z, s),
                         bp_code(v.w, s));
    }
    tail = n4 * 4;
  }
  for (long long i = tail + start; i < n; i += stride)
    out[i] = bp_code(x[i], s);
}
}  // namespace
extern "C" int oisma_bp_quantize(const void* xv, int, const float* scale,
                                 int8_t* out, long long n,
                                 cudaStream_t stream) {
  const float* x = static_cast<const float*>(xv);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  long long blocks = (n / 4 + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  bp_quantize_kernel<<<(int)blocks, 256, 0, stream>>>(x, scale, out, n, vec);
  return (int)cudaGetLastError();
}
"""
VARIANTS = {
    "main": [],
    "mmasync": [(MMA, "constexpr bool kCodesWgmma = true;",
                 "constexpr bool kCodesWgmma = false;")],
    "wgserial": [(MMA, 'asm volatile("wgmma.wait_group.sync.aligned 1;',
                  'asm volatile("wgmma.wait_group.sync.aligned 0;')],
    "cmpenc": [(MMA, "  const uint2 e = tab[c + 9];\n  lo = e.x;\n  hi = e.y;",
                "  float b8[8];\n  load8(b8, thr);\n"
                "  encode_val((int8_t)c, b8, lo, hi);")],
    "noxenc": [(MMA, "for (int u = tid; u < rows * BK / 4; u += T) {",
                "for (int u = tid; u < 0; u += T) {")],
    "noyenc": [(MMA, "for (int u = tid; u < BN * BK / 4; u += T) {",
                "for (int u = tid; u < 0; u += T) {")],
    "noyenc16": [(MMA, "for (int u = tid; u < BN / 2 * (BK / 4); u += T) {",
                  "for (int u = tid; u < 0; u += T) {")],
    "f32enc16": [(MMA,
                  "if constexpr (std::is_same<YT, __nv_bfloat16>::value) {",
                  "if constexpr (false) {"),
                 (MMA, "// A plane boundary b (f32) as bf16 bits",
                  "__device__ __forceinline__ void encode_val(\n"
                  "    __nv_bfloat16 v, const float* b, uint32_t& lo, "
                  "uint32_t& hi) {\n"
                  "  encode_val(__bfloat162float(v), b, lo, hi);\n}\n\n"
                  "// A plane boundary b (f32) as bf16 bits")],
    "nomma": [(MMA, "    for (int kk = 0; kk < BK * 8; kk += 32) {",
               "    for (int kk = 0; kk < 0; kk += 32) {"),
              (MMA, "        wgmma_s8(acc[0][0], da + 2 * kk, db + 2 * kk);",
               "        ;")],
    "noloop": [(MMA, "  for (int step = s0; step < s1; ++step) {",
                "  for (int step = s0; step < s0; ++step) {")],
    "nobnd": [(MMA, "if (!XC && (i < 8 || !CODED)) b = level_boundary8(*s, t);",
               "b = 0.1f * t;")],
    "noepi": [(MMA, "  if (!split) return;", "  return;")],
    "nosync": [(MMA, "    __syncthreads();\n\n#pragma unroll\n    for (int kk",
                "\n#pragma unroll\n    for (int kk")],
    "divq": [(QUANT, "for (int t = 0; t < 9; ++t) l += a >= b[t];",
              "l = (int)oisma_levels::bp_level(a, s);")],
    "nobndq": [(QUANT, "oisma_levels::level_boundary8(s, i < 9 ? i + 1 : 9);",
                "0.1f * i;")],
    "earlierq": [(QUANT, None, EARLIER_QUANTIZE)],
    "ldgq": [(QUANT, "r.w[i] = __ldcs(p + i);", "r.w[i] = p[i];")],
    "stcsq": [(QUANT, "*reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], "
                      "w[2], w[3]);",
               "__stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], "
               "w[2], w[3]));")],
    "wideq": [(QUANT, "constexpr int kUnits = 1;",
               "constexpr int kUnits = 2;")],
    "earlierp": [(POP, None, EARLIER_POPCOUNT)],
    "popgrid": [(POP, "  if (blocks > most) blocks = most;\n", "")],
    "popldg": [(POP, "__ldcs(mid + i)", "__ldg(mid + i)")],
}
#: variants that quantise f32 only (their bf16 case is not run)
F32_ONLY = ("earlierq",)
#: variants whose results must still equal the plain versions bitwise
EXACT = ("main", "mmasync", "cmpenc", "wgserial", "f32enc16", "divq",
         "earlierq", "ldgq", "stcsq", "wideq", "earlierp", "popgrid", "popldg")
SHAPES = [(4, 128, 2560), (4, 2560, 2560), (4, 2560, 640), (4, 6912, 2560),
          (64, 2560, 2560), (256, 2560, 6912)]
# h2o-danube-1.8b: (K, N) of one layer's wq, wk, wv, wo, up, gate, down
LAYER = [(2560, 2560), (2560, 640), (2560, 640), (2560, 2560), (2560, 6912),
         (2560, 6912), (6912, 2560)]
# (kernel, weight dtype, M, K, N); "layer" cases run the 7 projections
CASES = ([("mm", "float32", *s) for s in SHAPES]
         + [("mm", "bfloat16", 4, 2560, 2560), ("mm", "bfloat16", 4, 6912, 2560),
            ("mlp", "bfloat16", 4, 2560, 6912),
            ("mlp", "bfloat16", 64, 2560, 6912),
            ("mlp", "float32", 4, 2560, 6912),
            ("codes", "int8", 256, "layer", ""),
            ("codes", "int8", 4, 2560, 2560),
            ("codes", "int8", 256, 8192, 29568),
            ("quant", "float32", 256, "layer", ""),
            ("quant", "bfloat16", 256, "layer", "")]
         + [("pop", "int8", r, c, "") for r, c in
            [(524288, 16), (131072, 64), (32768, 256), (4096, 2048)]])


def build_all(names, only=None):
    from repro_torch.kernels import build
    dirs = {}
    for name in names:
        d = ROOT / "build" / f"var_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, a, b in VARIANTS[name]:     # a None: the whole file
            src = (d / fname).read_text()
            if a is not None and a not in src:
                raise SystemExit(f"{name}: {fname} no longer holds {a!r}")
            (d / fname).write_text(b if a is None else src.replace(a, b))
        dirs[name] = d
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        builds = {name: pool.submit(build.compile_library,
                                    sorted(d.glob("*.cu")), d / "lib.so")
                  for name, d in dirs.items()}
    for name, fut in builds.items():
        fut.result()          # raises with nvcc's output if a build failed
        r = subprocess.run([sys.executable, __file__, "--time", name]
                           + (["--only", only] if only else []),
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise SystemExit(f"{name}: {r.stderr[-3000:]}")
        print(r.stdout.strip())


def kernel_ms(torch, calls, flush, part, n=5):
    """Device time of the kernels named ``part`` per run of ``calls``, from
    the profiler, each call after the L2 flush."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            for f in calls:
                flush.zero_()
                f()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and part in e.key) / 1e3 / n


def time_variant(name, only=None):
    import torch
    from repro_torch.kernels import bp_matmul as kb
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fused as kf
    lib = ctypes.CDLL(str(ROOT / "build" / f"var_{name}" / "lib.so"))
    for fn, args in build._SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = list(args)
        f.restype = build._RESTYPES.get(fn, ctypes.c_int)
    build._lib = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def cold(calls, n=10):
        for f in calls:
            f()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(n):
            for f in calls:
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                f()
                e.record()
                pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / n

    def warm(calls, n=20):
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            for f in calls:
                f()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    def weight(k, n, dtype):
        return (randn(k, n, std=k ** -0.5)).to(getattr(torch, dtype))

    def codes_of(t):
        return ref.bp_quantize_ref(t, ref.tensor_scale(t))

    res = []
    for (kernel, dtype, m, k, n) in CASES:
        if kernel == "quant" and dtype != "float32" and name in F32_ONLY:
            continue
        if only and kernel != only:
            continue
        shapes = LAYER if k == "layer" else [(k, n)]
        if kernel == "mm":
            x, w = randn(m, k), weight(k, n, dtype)
            a = (x, w, ref.tensor_scale(x), ref.tensor_scale(w))
            calls = [lambda a=a: kf.fused_bp_matmul(*a)]
            ok = lambda a=a: torch.equal(  # noqa: E731
                calls[0](), ref.fused_matmul_ref(*a))
        elif kernel == "mlp":
            x = randn(m, k)
            up, gate = weight(k, n, dtype), weight(k, n, dtype)
            s = [ref.tensor_scale(t) for t in (x, up, gate)]
            calls = [lambda a=(x, up, gate, *s): kf.fused_mlp(*a)]
            ok = lambda: torch.allclose(  # noqa: E731
                calls[0](), ref.fused_mlp_ref(x, up, gate, "silu", *s),
                rtol=0, atol=1e-5)
        elif kernel == "codes":
            pairs = [(codes_of(randn(m, kk)), codes_of(weight(kk, nn,
                                                              "float32")))
                     for kk, nn in shapes]
            calls = [lambda p=p: kb.bp_matmul(*p) for p in pairs]
            ok = lambda pairs=pairs: all(  # noqa: E731
                torch.equal(kb.bp_matmul(*p), ref.bp_matmul_ref(*p))
                for p in pairs)
        elif kernel == "pop":
            bits = (randn(m, k) > 1.0).to(torch.int8)
            calls = [lambda: kb.popcount_accumulate(bits)]
            ok = lambda: torch.equal(  # noqa: E731
                calls[0](), ref.popcount_accumulate_ref(bits))
        else:
            ins = [randn(m, kk) for kk, _ in shapes] + [
                weight(kk, nn, dtype) for kk, nn in shapes]
            sc = [ref.tensor_scale(t) for t in ins]
            calls = [lambda t=t, c=c: kb.bp_quantize(t, c)
                     for t, c in zip(ins, sc)]
            ok = lambda ins=ins, sc=sc: all(  # noqa: E731
                torch.equal(kb.bp_quantize(t, c), ref.bp_quantize_ref(t, c))
                for t, c in zip(ins, sc))
        if name in EXACT and not ok():
            raise SystemExit(f"{name} differs from the plain version at "
                             f"{(kernel, dtype, m, k, n)}")
        iters = 3 if k == 8192 else 10
        line = (f"{kernel} {dtype} {m}x{k}x{n} cold {cold(calls, iters):.4f} "
                f"warm {warm(calls, 2 * iters):.4f}")
        if kernel == "pop":
            lib = [lambda: bits.sum(-1, dtype=torch.int32)]
            line += (f" kernel {kernel_ms(torch, calls, flush, 'popcount'):.4f}"
                     f" bits.sum cold {cold(lib, iters):.4f} kernel "
                     f"{kernel_ms(torch, lib, flush, 'reduce_kernel'):.4f}")
        res.append(line)
        del calls
    print(f"{name} ({torch.cuda.get_device_name(0)}, ms): " + " | ".join(res))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    args = sys.argv[1:]
    only = None
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    if args[:1] == ["--time"]:
        time_variant(args[1], only)
    else:
        names = args or list(VARIANTS)
        unknown = set(names) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}")
        build_all(names, only)
