"""Where the fused BP matmul's time goes on the card: time variants of its
integer core, each with one part cut out.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python scripts/torch_fused_matmul_variants.py

Each variant is a copy of ``src/repro_torch/kernels/csrc/`` in which one
piece of ``bp_mma.cuh`` is replaced (its results are then wrong; only
``main`` is checked bitwise against the plain version), built with the
port's nvcc flags into ``build/var_<name>/`` and timed in a process of
its own:

* ``main``: the kernel as it is;
* ``noyenc``: no weight encode (the plane tile keeps what it held);
* ``nomma``: no ldmatrix or mma;
* ``noloop``: no k steps at all (launches, boundary search, first copies,
  epilogue);
* ``nobnd``: no boundary search;
* ``noepi``: no split-K epilogue (atomics, tile counter, last split);
* ``nosync``: no barrier between the encode and the products.

Times are CUDA events around one call: ``cold`` after a write of 64 MB
(L2 flushed, as ``chip_smoke.py`` times), ``warm`` the mean of 20 calls
back to back.  Every line names the card it ran on.
"""
import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = {
    "main": [],
    "noyenc": [("    for (int u = tid; u < kBN * BK / 4; u += T) {",
                "    for (int u = tid; u < 0; u += T) {")],
    "nomma": [("    for (int kk = 0; kk < BK * 8; kk += 32) {",
               "    for (int kk = 0; kk < 0; kk += 32) {")],
    "noloop": [("  for (int step = s0; step < s1; ++step) {",
                "  for (int step = s0; step < s0; ++step) {")],
    "nobnd": [("if (i < 8 || !CODED) b = level_boundary8(i < 8 ? *sx_p : "
               "*sy_p, t);", "b = 0.1f * t;")],
    "noepi": [("  if (!split) return;", "  return;")],
    "nosync": [("    __syncthreads();\n\n#pragma unroll\n    for (int kk",
                "\n#pragma unroll\n    for (int kk")],
}
SHAPES = [(4, 128, 2560), (4, 2560, 2560), (4, 2560, 640), (4, 6912, 2560),
          (64, 2560, 2560), (256, 2560, 6912)]


def build_all():
    from repro_torch.kernels import build
    procs = {}
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
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               *sorted(str(p) for p in d.glob("*.cu"))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out[-3000:]}")
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

    res = []
    for (m, k, n) in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        a = (x, w, ref.tensor_scale(x), ref.tensor_scale(w))
        if name == "main" and not torch.equal(kf.fused_bp_matmul(*a),
                                              ref.fused_matmul_ref(*a)):
            raise SystemExit(f"main differs from the plain version at "
                             f"{(m, k, n)}")
        f = lambda: kf.fused_bp_matmul(*a)  # noqa: E731
        res.append(f"{m}x{k}x{n} cold {events(f, 10, True):.4f} warm "
                   f"{events(f, 20, False):.4f}")
    print(f"{name} ({torch.cuda.get_device_name(0)}, ms): " + " | ".join(res))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) > 1:
        time_variant(sys.argv[1])
    else:
        build_all()
