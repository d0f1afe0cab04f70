"""Where the fused BP matmul's and the fused BP MLP's time goes on the
card: time variants of their integer core (``bp_mma.cuh``), each with
one part cut out or done another way.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python scripts/torch_fused_matmul_variants.py

Each variant is a copy of ``src/repro_torch/kernels/csrc/`` in which one
piece of ``bp_mma.cuh`` is replaced (its results are then wrong; only
``main`` is checked bitwise against the plain version), built as the
port builds its library into ``build/var_<name>/`` and timed in a process
of its own:

* ``main``: the kernel as it is;
* ``noyenc``: no encode of f32 and int8 weights (the plane tile keeps
  what it held);
* ``noyenc16``: no encode of bf16 weights;
* ``f32enc16``: bf16 weights widened to f32 and encoded a value at a time
  by f32 compares, as f32 weights are, instead of two values a compare;
* ``nomma``: no ldmatrix or mma;
* ``noloop``: no k steps at all (launches, boundary search, first copies,
  epilogue);
* ``nobnd``: no boundary search;
* ``noepi``: no split-K epilogue (atomics, tile counter, last split);
* ``nosync``: no barrier between the encode and the products.

The cases: the fused matmul on f32 weights at the shapes below, and on
bf16 weights (the served path's form) at two decode shapes; the MLP on
bf16 weights at decode (4 rows) and a prefill chunk (64 rows), and on f32
weights at decode.  Times are CUDA events around one call: ``cold`` after
a write of 64 MB (L2 flushed, as ``chip_smoke.py`` times), ``warm`` the
mean of 20 calls back to back.  Every line names the card it ran on.
"""
import concurrent.futures
import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = {
    "main": [],
    "noyenc": [("for (int u = tid; u < BN * BK / 4; u += T) {",
                "for (int u = tid; u < 0; u += T) {")],
    "noyenc16": [("for (int u = tid; u < BN / 2 * (BK / 4); u += T) {",
                  "for (int u = tid; u < 0; u += T) {")],
    "f32enc16": [("if constexpr (std::is_same<YT, __nv_bfloat16>::value) {",
                  "if constexpr (false) {"),
                 ("// A plane boundary b (f32) as bf16 bits",
                  "__device__ __forceinline__ void encode_val(\n"
                  "    __nv_bfloat16 v, const float* b, uint32_t& lo, "
                  "uint32_t& hi) {\n"
                  "  encode_val(__bfloat162float(v), b, lo, hi);\n}\n\n"
                  "// A plane boundary b (f32) as bf16 bits")],
    "nomma": [("    for (int kk = 0; kk < BK * 8; kk += 32) {",
               "    for (int kk = 0; kk < 0; kk += 32) {")],
    "noloop": [("  for (int step = s0; step < s1; ++step) {",
                "  for (int step = s0; step < s0; ++step) {")],
    "nobnd": [("if (i < 8 || !CODED) b = level_boundary8(*s, t);",
               "b = 0.1f * t;")],
    "noepi": [("  if (!split) return;", "  return;")],
    "nosync": [("    __syncthreads();\n\n#pragma unroll\n    for (int kk",
                "\n#pragma unroll\n    for (int kk")],
}
SHAPES = [(4, 128, 2560), (4, 2560, 2560), (4, 2560, 640), (4, 6912, 2560),
          (64, 2560, 2560), (256, 2560, 6912)]
# (kernel, weight dtype, M, K, N)
CASES = ([("mm", "float32", *s) for s in SHAPES]
         + [("mm", "bfloat16", 4, 2560, 2560), ("mm", "bfloat16", 4, 6912, 2560),
            ("mlp", "bfloat16", 4, 2560, 6912),
            ("mlp", "bfloat16", 64, 2560, 6912),
            ("mlp", "float32", 4, 2560, 6912)])


def build_all():
    from repro_torch.kernels import build
    dirs = {}
    for name, subs in VARIANTS.items():
        d = ROOT / "build" / f"var_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = (d / "bp_mma.cuh").read_text()
        for a, b in subs:
            if a not in src:
                raise SystemExit(f"{name}: the kernel no longer holds {a!r}")
            src = src.replace(a, b)
        (d / "bp_mma.cuh").write_text(src)
        dirs[name] = d
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        builds = {name: pool.submit(build.compile_library,
                                    sorted(d.glob("*.cu")), d / "lib.so")
                  for name, d in dirs.items()}
    for name, fut in builds.items():
        fut.result()          # raises with nvcc's output if a build failed
        r = subprocess.run([sys.executable, __file__, name],
                           capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise SystemExit(f"{name}: {r.stderr[-3000:]}")
        print(r.stdout.strip())


def time_variant(name):
    import torch
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

    def events(f, n, cold):
        f()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(n if cold else 1):
            if cold:
                flush.zero_()
            torch.cuda._sleep(5_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(1 if cold else n):
                f()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / n

    def weight(k, n, dtype):
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        return w.to(getattr(torch, dtype))

    res = []
    for (kernel, dtype, m, k, n) in CASES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        if kernel == "mm":
            w = weight(k, n, dtype)
            a = (x, w, ref.tensor_scale(x), ref.tensor_scale(w))
            f = lambda a=a: kf.fused_bp_matmul(*a)  # noqa: E731
            ok = lambda a=a: torch.equal(  # noqa: E731
                f(), ref.fused_matmul_ref(*a))
        else:
            up, gate = weight(k, n, dtype), weight(k, n, dtype)
            s = [ref.tensor_scale(t) for t in (x, up, gate)]
            f = lambda a=(x, up, gate, *s): kf.fused_mlp(*a)  # noqa: E731
            ok = lambda: torch.allclose(  # noqa: E731
                f(), ref.fused_mlp_ref(x, up, gate, "silu", *s), rtol=0,
                atol=1e-5)
        if name in ("main", "f32enc16") and not ok():
            raise SystemExit(f"{name} differs from the plain version at "
                             f"{(kernel, dtype, m, k, n)}")
        res.append(f"{kernel} {dtype} {m}x{k}x{n} cold "
                   f"{events(f, 10, True):.4f} warm "
                   f"{events(f, 20, False):.4f}")
    print(f"{name} ({torch.cuda.get_device_name(0)}, ms): " + " | ".join(res))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) > 1:
        time_variant(sys.argv[1])
    else:
        build_all()
