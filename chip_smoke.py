#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored; each
prints its wall time):

1. Print the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; build the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a (one nvcc a source, all at once) and print
   the build seconds; check in the library's SASS (``cuobjdump``) that
   the kernels of the fused matmul, the fused MLP and the codes matmul
   multiply on the int8 tensor cores (IMMA from mma.sync; IGMMA from the
   codes matmul's 128-row wgmma instance), and print where any POPC sits.
2. Hold every kernel against its plain PyTorch version on the card, at the
   shapes h2o-danube-1.8b's decode step and prefill chunks give it
   (absmax, matmul, codes matmul and BP quantise bitwise, popcount exact,
   the quantise also on bf16 inputs, every finite bf16 pattern included,
   MLP within 1e-5 relative and relu bitwise, decode attention within
   1e-5), and time kernel, plain version and, where one exists, the
   PyTorch library call computing the same function (CUDA events, L2
   flushed before every call).  Weights are bf16, as the model holds them
   and the served path passes them; absmax, the matmul and the MLP are
   also timed on the f32 cast and checked bitwise against it.  absmax is
   checked with and without its floor, on ragged sizes and an unaligned
   view, and for one kernel a call; the fused matmul bitwise at M 1-256,
   with coded y, on its encode's plane boundaries, and for at most two
   kernels a call (profiler); the MLP at M 1-256 and ragged shapes with
   bf16, f32 and coded weights, and for at most two kernels a call;
   decode attention at S 1-4096, dead rows and qwen2-72b's heads (D 128,
   G 8); the codes matmul at M 1-256, ragged shapes and K 0, and for at
   most two kernels a call; the quantise timed on f32 and on bf16 weights,
   also by the profiler's kernel time; popcount on 8 MB tiles of 16, 64,
   256 and 2048 columns (event time, profiler kernel time with the L2
   flushed dirty and clean, bound, ``bits.sum``), exact there and on
   ragged rows starting at every misalignment, one kernel a call.  NaN
   and Inf: absmax, the fused matmul and MLP (a NaN or an Inf in x or a
   weight; relu with a NaN in w_gate) and decode attention (a NaN in q)
   give NaN where the plain version does and its values elsewhere.  The
   redesigned kernels' times print beside the earlier designs'
   (EARLIER_MS), and the build's ptxas registers and spills beside their
   dynamic shared memory.
3. Card vs CPU: h2o-danube at full width, 2 layers, the same seeded
   weights on both devices, 3 prompts, 8 greedy tokens each through the
   paged engine, in ``bp8_fused`` and in ``bp8`` (both over a ``bp8``
   cache); the card's path captured (the engine's default), the card's
   path eager (``capture=False``) and the CPU's plain path must emit the
   same tokens.
4. The served path: the full h2o-danube-1.8b (24 layers, full width,
   seeded random weights) in ``bp8_fused`` + ``bp8`` serves 8 requests
   (prompts of 32-256 tokens, 16 new tokens each) through
   ``PagedServeEngine`` (4 slots, block 16, prefill chunk 64), twice on
   one capturing engine (the first run captures each shape's CUDA graph;
   the second, timed, replays them) and once, after a short warm-up, on
   an eager engine: tokens/s of both, the capture seconds, peak device
   memory, and graphs per entry point, which must stay within
   ``compile_shape_bounds()``.  All three runs must emit the same tokens.
   Launch counts (a replay adds its graph's kernels) are zeroed just
   before the timed run and read just after; every kernel of the path
   must have launched, and must show by name in the profile of a captured
   run.  A prefill chunk and a decode step replayed from graphs must give
   the eager calls' caches and logits bitwise.  Short runs under
   ``torch.profiler``, captured and eager, give device time by kernel
   (the copy kernels of dtype casts apart), the idle share and the host
   time of the engine's ``paged.*`` ranges; decode steps of 2 and of 3
   layers the device launches and device time a decode layer adds, by
   kernel.
5. The unfused path: ``oisma_matmul(impl="unfused")`` at every projection
   shape of one h2o-danube-1.8b layer (4 and 256 rows) and at
   qwen2-72b's 256x8192x29568, with its accumulation periphery (the
   signed AND bits of every output as a row, summed by the popcount
   kernel, equal the codes matmul), each matmul also with its weight held
   as bf16 and read as stored.  Launch counts are zeroed just before and
   read just after; each result must equal ``impl="fused"`` bitwise.
6. Full depth in ``bp8``: the 24-layer h2o-danube-1.8b with
   ``matmul_mode="bp8"`` serves 2 requests x 8 new tokens twice on one
   capturing engine; tokens/s of the second run, peak device memory, and
   a profile of one short request.

The last lines are the kernels JSON (each kernel with the path its
launches come from), the card line, and ``{"ok": true, "device":
{...}}``.  A detail report goes to ``chip_smoke_report.json`` in the
output directory beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12        # HBM3, SXM data sheet
H100_INT8_OPS_PER_S = 1979e12     # dense int8 tensor-core rate
H100_F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores
REPLACES = {
    "absmax": "src/repro/kernels/fused.py:74",
    "fused_matmul": "src/repro/kernels/fused.py:140",
    "fused_mlp": "src/repro/kernels/fused.py:228",
    "decode_attention": "src/repro/kernels/attention.py:121",
    "bp_matmul": "src/repro/kernels/bp_matmul.py:95",
    "bp_quantize": "src/repro/kernels/bp_matmul.py:179",
    "popcount": "src/repro/kernels/bp_matmul.py:147",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
#: the path whose launch counts each kernel reports
PATHS = {"absmax": "serve_bp8_fused", "fused_matmul": "serve_bp8_fused",
         "fused_mlp": "serve_bp8_fused", "decode_attention": "serve_bp8_fused",
         "bp_matmul": "unfused", "bp_quantize": "unfused",
         "popcount": "unfused"}
#: the earlier designs' times (NVIDIA H100 80GB HBM3, 700 W; the
#: "Earlier ms" of PERF.md §6: f32 weights, absmax on f32 only, the MLP
#: on the popcount core; the codes matmul on the popcount core, the
#: quantise with a division per element, popcount one warp a row)
EARLIER_MS = {"absmax": 0.2246, "fused_matmul": 0.1959, "fused_mlp": 0.1695,
              "decode_attention": 0.0320, "bp_matmul": 4.2553,
              "bp_quantize": 0.2353, "popcount": 0.0098,
              "fused_matmul_prefill_64x2560x2560_ms": 0.0641,
              "fused_layer_256_rows_ms": 1.6818, "qwen2_72b_fused_ms": 4.0602}
EARLIER = "earlier design"
#: kernels whose registers and shared memory the build report prints
PTXAS_SHOWN = ("bp_mma_kernel", "absmax_kernel", "decode_partial_kernel",
               "decode_combine_kernel", "bp_quantize_kernel")
TINY = 1.1754943508222875e-38     # f32 tiny: the scales' floor
# h2o-danube-1.8b: d_model, q/o width, k/v width, d_ff
D, HD, KVD, FF = 2560, 2560, 640, 6912
#: (K, N) of one layer's projections: wq, wk, wv, wo, up, gate, down
LAYER = [(D, HD), (D, KVD), (D, KVD), (HD, D), (D, FF), (D, FF), (FF, D)]
QWEN_UP = (256, 8192, 29568)     # qwen2-72b's up projection at 256 tokens
#: 8 MB 0/1 tiles at the periphery's widths (16, 64, 256 columns) and 2048
POPCOUNT_WIDTHS = [(524288, 16), (131072, 64), (32768, 256), (4096, 2048)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean ms per iteration of a list of calls (the sum over the list),
    the L2 cache flushed before each call.  A device-side sleep ahead of
    each timed call lets the host enqueue the call before the card reaches
    it, so host-side launch overhead is not counted.

    The flush writes 64 MB, which leaves up to the L2's 50 MB dirty: a
    call that reads tens of MB then also pays for writing those lines
    back.  ``clean=True`` flushes by reading the 64 MB instead, so the
    call finds the L2 clean, as a served step finds it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, calls, iters: int = 10, clean: bool = False) -> float:
        torch = self.torch
        for f in calls:
            f()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            for f in calls:
                if clean:
                    self.flush.max()
                else:
                    self.flush.zero_()
                torch.cuda._sleep(2_000_000)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                f()
                e.record()
                events.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


#: CUDA API calls that enqueue device work (a kernel, a memset, a copy)
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")


def kernels_enqueued(torch, fn) -> dict:
    """Device work (kernels and memsets) one call of ``fn`` enqueues, by
    the CUDA API call that enqueued it, from the profiler; each count is
    the larger of two profiled calls.  The launches are counted where the
    host makes them: the profiler's record of the kernel itself is lost
    now and then (a session in which CUPTI requests a new activity buffer
    keeps the launch and drops the kernel), the record of the launch
    never."""
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


def ptxas_report(log: str) -> list:
    """``-Xptxas -v`` lines (registers, shared memory, spills) of the
    kernels named in PTXAS_SHOWN, one line per kernel instance."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in PTXAS_SHOWN if k in line), None)
            if name:
                out.append(line.split("'")[1] if "'" in line else line)
        elif name and ("Used" in line or "spill" in line):
            out[-1] += " |" + line.split(":", 1)[-1].rstrip()
    return out


def sass_counts(build, lib_path) -> dict:
    """Per kernel of the integer core (``bp_mma_kernel``: the fused matmul,
    the MLP and the codes matmul), the IMMA and IGMMA (int8 tensor-core:
    mma.sync and wgmma) and POPC instructions in the built library's SASS
    (``cuobjdump -sass``), and each POPC with the two instructions either
    side of it."""
    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    counts, name, body = {}, None, []

    def close():
        if name:
            ops = [ln.split(";")[0].split("*/")[-1].strip() for ln in body
                   if "*/" in ln]
            popc = [i for i, op in enumerate(ops) if "POPC" in op]
            counts[name] = {
                "IMMA": sum("IMMA" in op for op in ops),
                "IGMMA": sum("IGMMA" in op for op in ops), "POPC": len(popc),
                "POPC_context": [ops[max(0, i - 2):i + 3] for i in popc]}

    for line in out.stdout.splitlines():
        if "Function :" in line:
            close()
            fn = line.split("Function :", 1)[1].strip()
            name, body = (fn if "bp_mma_kernel" in fn else None), []
        elif name:
            body.append(line)
    close()
    return counts


def bound(byte_count: float, ops: float, peak_ops: float):
    tb, to = byte_count / H100_BYTES_PER_S, ops / peak_ops
    return max(tb, to) * 1e3, tb, to


def phase_kernels(torch, timer, dev="cuda"):
    """Kernel vs plain at the main path's shapes; returns per-kernel rows."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def weight(k, n):   # bf16, as the model holds its weights
        return (randn(k, n, std=k ** -0.5)).to(torch.bfloat16)

    def nbytes(t):
        return t.numel() * t.element_size()

    d, hd, kvd, ff = 2560, 2560, 640, 6912
    rows = {}
    detail = {}

    # ---- shapes of one layer of the decode step (M = 4 slots) ----
    M = 4
    mm_shapes = [(M, d, hd), (M, d, kvd), (M, d, kvd), (M, hd, d), (M, ff, d)]
    xs = {k: randn(M, k) for k in (d, ff)}
    ws = [weight(k, n) for (_, k, n) in mm_shapes]
    up, gate = weight(d, ff), weight(d, ff)

    # absmax: 13 per layer (x and w of 5 dense calls, x/up/gate of the
    # MLP), floored at f32 tiny in the same launch; x f32, weights bf16
    am_in = ([xs[k] for (_, k, _) in mm_shapes] + ws + [xs[d], up, gate])
    am_f32 = [t.float() for t in am_in]
    ragged = randn(4103)
    am_checked = am_in + [randn(1), randn(7), randn(4097), ragged[1:4100],
                          ragged.to(torch.bfloat16)[1:4100]]
    for t in am_checked:
        for lo in (0.0, TINY):
            a = kf.absmax(t, lo)
            if not torch.equal(a, ref.absmax_ref(t, lo)):
                fail(f"absmax differs at {tuple(t.shape)} {t.dtype} floor "
                     f"{lo}: {a.item()} vs {ref.absmax_ref(t, lo).item()}")
            if not torch.equal(kf.absmax(t, lo), a):
                fail(f"absmax differs between two calls at {tuple(t.shape)}")
            if t.dtype == torch.bfloat16 and not torch.equal(
                    a, kf.absmax(t.float(), lo)):
                fail(f"absmax of bf16 differs from its f32 cast at "
                     f"{tuple(t.shape)}")
    if not torch.equal(kf.absmax(torch.zeros_like(up), TINY),
                       torch.full((1, 1), TINY, device=dev)):
        fail("absmax of zeros is not the floor")
    seen = {f"{tuple(t.shape)} {t.dtype}": kernels_enqueued(
        torch, lambda t=t: kf.absmax(t, TINY)) for t in (xs[d], up)}
    if any(sum(n.values()) != 1 for n in seen.values()):
        fail(f"absmax enqueued {seen} (one kernel a call)")
    detail["absmax_kernels_per_call"] = {k: sum(n.values())
                                         for k, n in seen.items()}
    rows["absmax"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
        plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY) for t in am_in]),
        library_ms=timer([lambda t=t: torch.amax(t.abs()) for t in am_in]),
        b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
           for t in am_in])
    detail["absmax_f32_weights_ms"] = timer(
        [lambda t=t: kf.absmax(t, TINY) for t in am_f32])
    detail["absmax_f32_weights_bound_ms"] = sum(
        bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)[0]
        for t in am_f32)
    # what the timer costs a call by itself (one one-element kernel), and
    # the 13 scans with the L2 left clean, as a served step leaves it
    one = torch.empty(1, device=dev)
    detail["timer_one_element_kernel_ms"] = timer([lambda: one.zero_()])
    detail["absmax_clean_l2_ms"] = timer(
        [lambda t=t: kf.absmax(t, TINY) for t in am_in], clean=True)

    # fused matmul: 5 per layer; bitwise, plus prefill rows, coded y, and
    # a ragged shape; a bf16 weight equals its f32 cast bitwise
    def scales(x, y):
        return kf.absmax(x, TINY), kf.absmax(y, TINY)

    mm_calls, mm_f32, mm_plain, mm_bounds = [], [], [], []
    for (m, k, n), w in zip(mm_shapes, ws):
        x = xs[k]
        sx, sy = scales(x, w)
        a = kf.fused_bp_matmul(x, w, sx, sy)
        b = ref.fused_matmul_ref(x, w, sx, sy)
        if not torch.equal(a, b):
            fail(f"fused matmul differs at {(m, k, n)}: max "
                 f"{(a - b).abs().max().item()}")
        wf = w.float()
        if not torch.equal(a, kf.fused_bp_matmul(x, wf, sx, sy)):
            fail(f"fused matmul: bf16 y differs from its f32 cast at "
                 f"{(m, k, n)}")
        mm_calls.append(lambda x=x, w=w, sx=sx, sy=sy:
                        kf.fused_bp_matmul(x, w, sx, sy))
        mm_f32.append(lambda x=x, w=wf, sx=sx, sy=sy:
                      kf.fused_bp_matmul(x, w, sx, sy))
        mm_plain.append(lambda x=x, w=w, sx=sx, sy=sy:
                        ref.fused_matmul_ref(x, w, sx, sy))
        mm_bounds.append(bound(4 * m * k + nbytes(w) + 8 + 4 * m * n,
                               2 * m * n * 8 * k, H100_INT8_OPS_PER_S))
    extra = []
    for (m, k, n) in ([(m, d, hd) for m in (1, 4, 8, 16, 64, 65, 256)]
                      + [(64, ff, d), (130, 100, 96), (1, 7, 5), (3, 33, 50)]):
        x, w = randn(m, k), weight(k, n)
        sx, sy = scales(x, w)
        a = kf.fused_bp_matmul(x, w, sx, sy)
        if not torch.equal(a, ref.fused_matmul_ref(x, w, sx, sy)):
            fail(f"fused matmul differs at {(m, k, n)}")
        if not torch.equal(a, kf.fused_bp_matmul(x, w.float(), sx, sy)):
            fail(f"fused matmul: bf16 y differs from f32 at {(m, k, n)}")
        codes, cs = ops.prepare_bp_weight(w)
        if not torch.equal(kf.fused_bp_matmul(x, codes, sx, cs),
                           ref.fused_matmul_ref(x, codes, sx, cs)):
            fail(f"fused matmul with int8-coded y differs at {(m, k, n)}")
        extra.append((m, k, n))
    codes, cs = ops.prepare_bp_weight(ws[1])
    a = ops.oisma_matmul(xs[d], codes, y_scale=cs)
    if not torch.equal(a, ref.fused_matmul_ref(xs[d], codes, None, cs)):
        fail("fused matmul with int8-coded y differs")
    # operands exactly on the encode's plane boundaries and one ulp off:
    # x at several scales, y at scale 1 (so that sx * sy stays finite)
    def on_edges(sc, *shape):
        s_ = torch.full((1, 1), sc, device=dev)
        b = ref.level_boundaries(s_)
        inf = torch.full_like(b, math.inf)
        vals = torch.cat([b, torch.nextafter(b, inf), torch.nextafter(b, -inf),
                          torch.zeros(1, device=dev), s_.reshape(1)])
        i = torch.randint(0, len(vals), shape, generator=gen, device=dev)
        sign = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
        return vals[i] * sign, s_

    wb, sw = on_edges(1.0, d, kvd)
    for sc in (0.37, 5.128217, TINY, 3e38):
        for m in (8, 72):
            xb, s_ = on_edges(sc, m, d)
            if not torch.equal(kf.fused_bp_matmul(xb, wb, s_, sw),
                               ref.fused_matmul_ref(xb, wb, s_, sw)):
                fail(f"fused matmul differs on the plane boundaries of "
                     f"scale {sc} at M {m}")
    launches = {}
    for (m, k, n) in sorted(set(mm_shapes) | {(64, d, hd), (256, d, ff),
                                              (1, 7, 5)}):
        x, w = randn(m, k), weight(k, n)
        sx, sy = scales(x, w)
        seen = kernels_enqueued(torch, lambda: kf.fused_bp_matmul(
            x, w, sx, sy))
        if not 1 <= sum(seen.values()) <= 2:
            fail(f"fused matmul at {(m, k, n)}: {seen} enqueued (at most "
                 f"2 kernels)")
        launches["x".join(map(str, (m, k, n)))] = sum(seen.values())
    detail["fused_matmul_kernels_per_call"] = launches
    x64 = randn(64, d)
    p64 = (x64, ws[0], *scales(x64, ws[0]))
    detail["fused_matmul_prefill_64x2560x2560_ms"] = timer(
        [lambda: kf.fused_bp_matmul(*p64)])
    rows["fused_matmul"] = dict(max_abs_err=0.0, ms=timer(mm_calls),
                                plain_ms=timer(mm_plain, iters=3),
                                library_ms=None, b=mm_bounds)
    detail["fused_matmul_f32_weights_ms"] = timer(mm_f32)
    detail["fused_matmul_f32_weights_bound_ms"] = sum(
        bound(4 * m * k + 4 * k * n + 8 + 4 * m * n, 2 * m * n * 8 * k,
              H100_INT8_OPS_PER_S)[0] for (m, k, n) in mm_shapes)
    detail["fused_matmul_checked_extra_shapes"] = extra

    # fused MLP: 1 per layer; 1e-5 relative to the output's magnitude for
    # silu and gelu, bitwise for relu; bf16, f32 and coded weights
    def mlp_err(a, b, act, what):
        e = ((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()
        if act == "relu" and not torch.equal(a, b):
            fail(f"fused MLP (relu, {what}) not bitwise: {e:.3g}")
        if not math.isfinite(e) or e > 1e-5:
            fail(f"fused MLP ({act}, {what}) off by {e:.3g}")
        return (a - b).abs().max().item()

    def mlp_weights(k, f, kind):
        u, g = weight(k, f), weight(k, f)
        if kind == "coded":
            (u, su_), (g, sg_) = ops.prepare_bp_weight(u), \
                ops.prepare_bp_weight(g)
            return u, g, su_, sg_
        if kind == "f32":
            u, g = u.float(), g.float()
        return u, g, kf.absmax(u, TINY), kf.absmax(g, TINY)

    err = 0.0
    x = xs[d]
    sx, su, sg = (kf.absmax(t, TINY) for t in (x, up, gate))
    mlp_checked = []
    for (m, k, f) in ([(m, d, ff) for m in (1, 4, 8, 16, 64, 65, 256)]
                      + [(130, 100, 96), (1, 7, 5)]):
        xx = randn(m, k)
        s0 = kf.absmax(xx, TINY)
        for kind in ("bf16", "f32", "coded"):
            if k == d and kind != "bf16" and m not in (4, 64):
                continue          # the wide f32 and coded cases: 4, 64 rows
            u, g, su_, sg_ = mlp_weights(k, f, kind)
            for act in ("silu", "gelu", "relu"):
                a = kf.fused_mlp(xx, u, g, s0, su_, sg_, act)
                b = ref.fused_mlp_ref(xx, u, g, act, s0, su_, sg_)
                err = max(err, mlp_err(a, b, act, f"{kind}, {(m, k, f)}"))
                if kind == "bf16" and not torch.equal(a, kf.fused_mlp(
                        xx, u.float(), g.float(), s0, su_, sg_, act)):
                    fail(f"fused MLP: bf16 weights differ from their f32 "
                         f"cast at {(m, k, f)} ({act})")
            mlp_checked.append((m, k, f, kind))
    detail["fused_mlp_checked"] = mlp_checked
    mlp_launches = {}
    for m in (4, 64):
        xx = randn(m, d)
        args = (xx, up, gate, kf.absmax(xx, TINY), su, sg, "silu")
        seen = kernels_enqueued(torch, lambda: kf.fused_mlp(*args))
        if not 1 <= sum(seen.values()) <= 2:
            fail(f"fused MLP at M {m}: {seen} enqueued (at most 2 kernels)")
        mlp_launches[f"{m}x{d}x{ff}"] = sum(seen.values())
    detail["fused_mlp_kernels_per_call"] = mlp_launches
    upf, gatef = up.float(), gate.float()
    rows["fused_mlp"] = dict(
        max_abs_err=err,
        ms=timer([lambda: kf.fused_mlp(x, up, gate, sx, su, sg, "silu")]),
        plain_ms=timer([lambda: ref.fused_mlp_ref(x, up, gate, "silu", sx,
                                                  su, sg)], iters=3),
        library_ms=None,
        b=[bound(4 * M * d + nbytes(up) + nbytes(gate) + 12 + 4 * M * ff,
                 2 * 2 * M * ff * 8 * d, H100_INT8_OPS_PER_S)])
    detail["fused_mlp_f32_weights_ms"] = timer(
        [lambda: kf.fused_mlp(x, upf, gatef, sx, su, sg, "silu")])
    detail["fused_mlp_f32_weights_bound_ms"] = bound(
        4 * M * d + 8 * d * ff + 12 + 4 * M * ff, 2 * 2 * M * ff * 8 * d,
        H100_INT8_OPS_PER_S)[0]
    x64 = randn(64, d)
    p64 = (x64, up, gate, kf.absmax(x64, TINY), su, sg, "silu")
    detail["fused_mlp_clean_l2_ms"] = timer(
        [lambda: kf.fused_mlp(x, up, gate, sx, su, sg, "silu")], clean=True)
    detail["fused_mlp_prefill_64x2560x6912_ms"] = timer(
        [lambda: kf.fused_mlp(*p64)])
    detail["fused_mlp_prefill_64x2560x6912_bound_ms"] = bound(
        4 * 64 * d + nbytes(up) + nbytes(gate) + 12 + 4 * 64 * ff,
        2 * 2 * 64 * ff * 8 * d, H100_INT8_OPS_PER_S)[0]

    # decode attention: B=4 rows, 8 kv heads x 4 queries, D=80, S=1024
    def cache(b, s, kh, dd, empty_tail=0, dead_row=False):
        kc, ks = ka.quantize_kv(randn(b, s, kh, dd))
        vc, vs = ka.quantize_kv(randn(b, s, kh, dd))
        pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1)
        if empty_tail:
            pos[0, s - empty_tail:] = -1
        if dead_row:
            pos[-1] = -1
        qp = (pos.max(dim=1).values.clamp_min(0)).to(torch.int32)
        return kc, ks, vc, vs, pos, qp

    B, KH, G, D, S = 4, 8, 4, 80, 1024
    q = randn(B, KH, G, D) / math.sqrt(D)
    main = cache(B, S, KH, D)
    err = 0.0
    cases = [(q, main, 4096, None),
             (q, cache(B, S, KH, D, empty_tail=100, dead_row=True), 100, 30.0),
             (randn(2, 2, 4, 80), cache(2, 48, 2, 80, empty_tail=5), 17, None),
             (q, cache(B, 1, KH, D), 4096, None),
             (q, cache(B, 33, KH, D, dead_row=True), 4096, None),
             (q, cache(B, 4096, KH, D, empty_tail=1000, dead_row=True), 1500,
              30.0),
             # qwen2-72b's heads: D 128, G 8
             (randn(B, KH, 8, 128) / math.sqrt(128),
              cache(B, 1024, KH, 128, dead_row=True), 4096, None)]
    for qq, cc, win, cap in cases:
        a = ka.bp8_decode_attention(qq, *cc, win, softcap=cap)
        b = ka.bp8_decode_attention_ref(qq, *cc, win, softcap=cap)
        e = (a - b).abs().max().item()
        if not math.isfinite(e) or e > 1e-5:
            fail(f"decode attention (S={cc[0].shape[1]}, window {win}, "
                 f"softcap {cap}) off by {e:.3g}")
        err = max(err, e)
    kc, ks, vc, vs, pos, qp = main
    kd, vd = ka.dequantize_kv(kc, ks), ka.dequantize_kv(vc, vs)
    qs = q.reshape(B, KH * G, 1, D)
    kt = kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vt = vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    mask = ((pos >= 0) & (pos <= qp[:, None])
            & (qp[:, None] - pos < 4096))[:, None, None, :]
    F = torch.nn.functional
    rows["decode_attention"] = dict(
        max_abs_err=err,
        ms=timer([lambda: ka.bp8_decode_attention(q, *main, 4096)]),
        plain_ms=timer([lambda: ka.bp8_decode_attention_ref(q, *main, 4096)]),
        library_ms=timer([lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=1.0)]),
        b=[bound(4 * B * KH * G * D * 2 + 2 * B * S * KH * D
                 + 2 * 4 * B * S * KH + 4 * B * S + 4 * B,
                 4 * B * KH * G * S * D, H100_F32_FLOPS_PER_S)])
    detail["nan_and_inf_checked"] = nan_and_inf_checks(torch, randn, dev)
    unfused_kernel_rows(torch, timer, randn,
                        lambda k, n: weight(k, n).float(), rows, detail, dev)
    return rows, detail


def nan_and_inf_checks(torch, randn, dev):
    """NaN where the plain version has NaN, its bits everywhere else: absmax
    (f32 and bf16, aligned and not, the special value first, in the middle
    and last), the fused matmul and MLP with a NaN or an Inf in x (and in
    the weight), the relu MLP with a NaN in w_gate, decode attention with
    a NaN in q (within 1e-5 elsewhere).  The reference propagates NaN
    through every max and the relu, and so do the plain versions."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ops, ref

    def put(x, vals, at):
        x = x.clone()
        for j, v in enumerate(vals):
            x.view(-1)[(at + 3 * j) % x.numel()] = v
        return x

    def same(a, b, what, atol=0.0):
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        if not torch.equal(nan_a, nan_b):
            fail(f"{what}: NaN at {int(nan_a.sum())} places, plain "
                 f"{int(nan_b.sum())}")
        ok = ~nan_b
        if atol == 0.0 and not torch.equal(a[ok], b[ok]):
            fail(f"{what}: differs from the plain version off the NaNs")
        if atol and not bool(((a[ok] - b[ok]).abs() <= atol).all()):
            fail(f"{what}: off by more than {atol} off the NaNs")
        return int(nan_b.sum())

    nan, inf = float("nan"), float("inf")
    specials = {"nan": (nan,), "inf": (inf,), "-inf": (-inf,),
                "nan+inf": (nan, inf)}
    checked = []
    base = randn(4097)
    for dtype in (torch.float32, torch.bfloat16):
        for x in (base[:4096].to(dtype), base[1:].to(dtype)):
            for name, vals in specials.items():
                for at in (0, 2048, x.numel() - 1):
                    t = put(x, vals, at)
                    for lo in (0.0, TINY):
                        n = same(kf.absmax(t, lo), ref.absmax_ref(t, lo),
                                 f"absmax {dtype} {name} at {at}")
                        if n != (name.startswith("nan")):
                            fail(f"absmax {dtype} {name}: NaN {n}")
    checked.append("absmax: f32/bf16 x aligned/unaligned x 4 x 3 places")
    x = randn(4, D)
    wq = (randn(D, KVD) * D ** -0.5).to(torch.bfloat16)
    for name, vals in specials.items():
        for xs, ws in ((put(x, vals, 5), wq),
                       (x, put(wq.float(), vals, 5).to(torch.bfloat16))):
            n = same(ops.oisma_matmul(xs, ws), ref.fused_matmul_ref(xs, ws),
                     f"fused matmul, {name}")
            if n != 4 * KVD:
                fail(f"fused matmul, {name}: NaN at {n} of {4 * KVD}")
    checked.append("fused matmul 4x2560x640: 4 specials in x and in w")
    up, gate = ((randn(D, FF) * D ** -0.5).to(torch.bfloat16)
                for _ in range(2))
    for act in ("silu", "gelu", "relu"):
        for name, vals in specials.items():
            xs = put(x, vals, 11)
            same(ops.oisma_mlp(xs, up, gate, act=act),
                 ref.fused_mlp_ref(xs, up, gate, act), f"MLP {act}, {name}",
                 atol=1e-5)
    g_nan = put(gate.float(), (nan,), 17).to(torch.bfloat16)
    n = same(ops.oisma_mlp(x, up, g_nan, act="relu"),
             ref.fused_mlp_ref(x, up, g_nan, "relu"), "MLP relu, NaN gate")
    if n != 4 * FF:
        fail(f"MLP relu, NaN in w_gate: NaN at {n} of {4 * FF}")
    checked.append("fused MLP 4x2560x6912: 3 acts x 4 specials in x; relu "
                   "with a NaN in w_gate")
    b, kh, g, d, s_ = 4, 8, 4, 80, 1024
    q = randn(b, kh, g, d) / math.sqrt(d)
    q[1, 2, 3, 7] = nan
    kc, ks = ka.quantize_kv(randn(b, s_, kh, d))
    vc, vs = ka.quantize_kv(randn(b, s_, kh, d))
    pos = torch.arange(s_, device=dev, dtype=torch.int32)[None].repeat(b, 1)
    qp = torch.full((b,), s_ - 1, dtype=torch.int32, device=dev)
    args = (q, kc, ks, vc, vs, pos, qp, None)
    n = same(ka.bp8_decode_attention(*args), ka.bp8_decode_attention_ref(
        *args), "decode attention, NaN in q", atol=1e-5)
    if n != d:
        fail(f"decode attention, NaN in q: NaN at {n}, want {d}")
    checked.append("decode attention B4 KH8 G4 D80 S1024, a NaN in q")
    print("NaN and Inf: " + "; ".join(checked) + ": as the plain versions")
    return checked


def kernel_device_ms(torch, timer, calls, part: str,
                     clean: bool = False) -> float:
    """Device time per run of ``calls`` of the kernels whose name holds
    ``part``, from the profiler (each call after the timer's L2 flush, as
    the event times are taken, or with ``clean`` its flush by reading; the
    flush's own kernel is not counted).  A session that recorded none of
    those kernels is taken again, up to 4 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    runs = 5
    for f in calls:
        f()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                for f in calls:
                    if clean:
                        timer.flush.max()
                    else:
                        timer.flush.zero_()
                    f()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and part in e.key)
        if us > 0:
            break
    return us / 1e3 / runs


def unfused_kernel_rows(torch, timer, randn, weight, rows, detail, dev):
    """The unfused pipeline's kernels against their plain versions: the
    codes matmul and the BP quantise bitwise (the quantise on f32 and bf16
    inputs), popcount exact; timed over one layer at 256 rows (the unfused
    path's prefill half)."""
    from repro_torch.kernels import bp_matmul as kb
    from repro_torch.kernels import ref
    from repro_torch.core.quantize import quantize_bp

    def codes_of(t):
        return ref.bp_quantize_ref(t, ref.tensor_scale(t))

    def ints(*shape, lo, hi):     # seeded integers in [lo, hi] as int8
        return (randn(*shape) * (hi - lo) / 4).round().clamp(lo, hi).to(
            torch.int8)

    # codes matmul: codes of real data at the layer's shapes and at every
    # row-block instance (M 1-256), plus ragged shapes and K 0
    checked = []
    for (m, k, n) in ([(4, D, HD), (4, D, KVD), (4, FF, D), (256, D, HD),
                       (256, D, FF), (256, FF, D)]
                      + [(m, D, KVD) for m in (1, 16, 64, 65, 128)]):
        xc, yc = codes_of(randn(m, k)), codes_of(weight(k, n))
        if not torch.equal(kb.bp_matmul(xc, yc), ref.bp_matmul_ref(xc, yc)):
            fail(f"codes matmul differs at {(m, k, n)}")
        checked.append((m, k, n))
    for (m, k, n) in [(130, 100, 96), (1, 7, 5), (100, 300, 130),
                      (129, 257, 130), (256, 6912, 40), (3, 0, 4),
                      (200, 0, 130)]:
        xc, yc = ints(m, k, lo=-9, hi=9), ints(k, n, lo=-9, hi=9)
        if not torch.equal(kb.bp_matmul(xc, yc), ref.bp_matmul_ref(xc, yc)):
            fail(f"codes matmul differs at {(m, k, n)}")
        checked.append((m, k, n))
    detail["bp_matmul_checked_shapes"] = checked
    launches = {}
    for (m, k, n) in [(4, D, HD), (64, D, KVD), (256, D, FF), (1, 7, 5),
                      (3, 0, 4)]:
        xc, yc = ints(m, k, lo=-9, hi=9), ints(k, n, lo=-9, hi=9)
        seen = kernels_enqueued(torch, lambda: kb.bp_matmul(xc, yc))
        if not 1 <= sum(seen.values()) <= 2:
            fail(f"codes matmul at {(m, k, n)}: {seen} enqueued (at most 2 "
                 f"kernels)")
        launches["x".join(map(str, (m, k, n)))] = sum(seen.values())
    detail["bp_matmul_kernels_per_call"] = launches
    M = 256
    xcs = {k: codes_of(randn(M, k)) for k in (D, FF)}
    ycs = [codes_of(weight(k, n)) for (k, n) in LAYER]
    pairs = [(xcs[k], yc) for (k, _), yc in zip(LAYER, ycs)]
    rows["bp_matmul"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda a=a, b=b: kb.bp_matmul(a, b) for a, b in pairs]),
        plain_ms=timer([lambda a=a, b=b: ref.bp_matmul_ref(a, b)
                        for a, b in pairs], iters=3),
        library_ms=None,
        b=[bound(M * k + k * n + 4 * M * n, 2 * M * n * 8 * k,
                 H100_INT8_OPS_PER_S) for (k, n) in LAYER])
    detail["bp_matmul_256x2560x6912_ms"] = timer(
        [lambda: kb.bp_matmul(xcs[D], ycs[4])])
    x4 = xcs[D][:4].contiguous()
    detail["bp_matmul_4x2560x2560_ms"] = timer(
        [lambda: kb.bp_matmul(x4, ycs[0])])
    detail["bp_matmul_4x2560x2560_bound_ms"] = bound(
        4 * D + D * HD + 4 * 4 * HD, 2 * 4 * HD * 8 * D,
        H100_INT8_OPS_PER_S)[0]

    # BP quantise: the 14 operands of one layer at 256 rows (7 x, 7 w),
    # bitwise on f32 and on the weights held as bf16, plus half-level
    # boundaries, quantize_bp's codes and every finite bf16 pattern
    ins = [randn(M, k) for (k, _) in LAYER] + [weight(k, n)
                                                for (k, n) in LAYER]
    scales = [ref.tensor_scale(t) for t in ins]
    ins16 = ins[:7] + [t.to(torch.bfloat16) for t in ins[7:]]
    for t, sc in zip(ins + ins16[7:], scales + scales[7:]):
        if not torch.equal(kb.bp_quantize(t, sc),
                           ref.bp_quantize_ref(t.float(), sc)):
            fail(f"BP quantise differs at {tuple(t.shape)} {t.dtype}")
    v = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    v = v.to(torch.int16).view(torch.bfloat16)
    every = v[torch.isfinite(v)]
    for sc in (5.128217, 0.37, TINY, 3e38, None):
        s_ = (ref.tensor_scale(every.float()) if sc is None
              else torch.full((1, 1), sc, device=dev))
        for t in (every, every[1:]):
            if not torch.equal(kb.bp_quantize(t, s_),
                               ref.bp_quantize_ref(t.float(), s_)):
                fail(f"BP quantise differs on the finite bf16 patterns "
                     f"(scale {s_.item()}, {t.numel()} values)")
    q = quantize_bp(ins[-1])
    if not torch.equal(kb.bp_quantize(ins[-1], scales[-1]), ref.to_codes(q)):
        fail("BP quantise differs from quantize_bp's codes")
    sc = scales[7]
    mid = (torch.arange(9, device=dev) + 0.5) * sc[0, 0] / 10
    edge = torch.cat([mid, torch.nextafter(mid, mid + 1),
                      torch.nextafter(mid, mid - 1)])
    edge = torch.cat([edge, -edge])
    if not torch.equal(kb.bp_quantize(edge, sc), ref.bp_quantize_ref(edge, sc)):
        fail("BP quantise differs at half-level boundaries")
    q32 = [lambda t=t, c=c: kb.bp_quantize(t, c) for t, c in zip(ins, scales)]
    q16 = [lambda t=t, c=c: kb.bp_quantize(t, c)
           for t, c in zip(ins16, scales)]
    rows["bp_quantize"] = dict(
        max_abs_err=0.0, ms=timer(q32),
        plain_ms=timer([lambda t=t, c=c: ref.bp_quantize_ref(t, c)
                        for t, c in zip(ins, scales)]),
        library_ms=None,
        b=[bound(5 * t.numel() + 4, 3 * t.numel(), H100_F32_FLOPS_PER_S)
           for t in ins])
    detail["bp_quantize_kernel_time_ms"] = kernel_device_ms(
        torch, timer, q32, "bp_quantize")
    detail["bp_quantize_bf16_weights_ms"] = timer(q16)
    detail["bp_quantize_bf16_weights_kernel_time_ms"] = kernel_device_ms(
        torch, timer, q16, "bp_quantize")
    detail["bp_quantize_bf16_weights_bound_ms"] = sum(
        bound((t.element_size() + 1) * t.numel() + 4, 3 * t.numel(),
              H100_F32_FLOPS_PER_S)[0] for t in ins16)

    # popcount: 0/1 tiles at the periphery's widths, then int8, uint8 and
    # bool tiles of any value, ragged and starting at every misalignment
    tiles = [ints(*shape, lo=0, hi=1)
             for shape in POPCOUNT_WIDTHS + [(300, 100)]]
    wide = ints(513, 1000, lo=-128, hi=127)
    tiles += [wide, wide.to(torch.uint8), wide > 0]
    flat = ints(77 * 257 + 16, lo=-128, hi=127)
    for buf in (flat, flat.view(torch.uint8), flat > 0):
        for c in (1, 15, 16, 33, 100, 257):
            tiles += [buf[o:o + 77 * c].view(77, c) for o in range(16)]
    for t in tiles:
        if not torch.equal(kb.popcount_accumulate(t),
                           ref.popcount_accumulate_ref(t)):
            fail(f"popcount differs at {tuple(t.shape)} {t.dtype}")
    for t in tiles[:len(POPCOUNT_WIDTHS)]:
        seen = kernels_enqueued(torch, lambda t=t: kb.popcount_accumulate(t))
        if sum(seen.values()) != 1:
            fail(f"popcount at {tuple(t.shape)}: {seen} enqueued (one "
                 f"kernel a call)")
    big = tiles[len(POPCOUNT_WIDTHS) - 1]          # (4096, 2048)
    r, c = big.shape
    rows["popcount"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda: kb.popcount_accumulate(big)]),
        plain_ms=timer([lambda: ref.popcount_accumulate_ref(big)]),
        library_ms=timer([lambda: big.sum(-1, dtype=torch.int32)]),
        b=[bound(r * c + 4 * r, r * c, H100_F32_FLOPS_PER_S)])
    widths = {}
    for t in tiles[:len(POPCOUNT_WIDTHS)]:
        r, c = t.shape
        widths[f"{r}x{c}"] = {
            "ms": timer([lambda t=t: kb.popcount_accumulate(t)]),
            "kernel_ms": kernel_device_ms(
                torch, timer, [lambda t=t: kb.popcount_accumulate(t)],
                "popcount_kernel"),
            # the L2 flushed by reading: no dirty lines to write back
            "kernel_clean_l2_ms": kernel_device_ms(
                torch, timer, [lambda t=t: kb.popcount_accumulate(t)],
                "popcount_kernel", clean=True),
            "bound_ms": bound(r * c + 4 * r, r * c, H100_F32_FLOPS_PER_S)[0],
            "bits_sum_ms": timer([lambda t=t: t.sum(-1, dtype=torch.int32)]),
            "bits_sum_kernel_ms": kernel_device_ms(
                torch, timer, [lambda t=t: t.sum(-1, dtype=torch.int32)],
                "reduce_kernel")}
    detail["popcount_widths"] = widths
    print("popcount by width (event ms, profiler kernel ms, the same with "
          "the L2 clean, bound ms; bits.sum event and kernel ms): "
          + "; ".join(
              f"{k}: {v['ms']:.4f}, {v['kernel_ms']:.4f}, "
              f"{v['kernel_clean_l2_ms']:.4f}, "
              f"{v['bound_ms']:.5f}; {v['bits_sum_ms']:.4f}, "
              f"{v['bits_sum_kernel_ms']:.4f}" for k, v in widths.items()))


def make_engine(cfg, params, device, capture=None):
    from repro_torch.models import build
    from repro_torch.serve.paged_engine import (PagedEngineConfig,
                                                PagedServeEngine)
    ecfg = PagedEngineConfig(slots=4, block_size=16, num_blocks=96,
                             max_prefill_tokens=64, eos_id=-1)
    return PagedServeEngine(build(cfg), params, cfg, ecfg, device=device,
                            capture=capture)


def serve(torch, cfg, params, prompts, max_new, device, engine=None,
          capture=None):
    """Serve ``prompts`` on ``engine`` (a new one if None); returns
    (tokens by request, seconds, engine)."""
    from repro_torch.serve.paged_engine import PagedRequest
    if engine is None:
        engine = make_engine(cfg, params, device, capture)
    reqs = [PagedRequest(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, engine


#: served-path kernels by the device names they run under
SERVED_KERNEL_NAMES = (("absmax", "absmax_kernel"),
                       ("decode_attention", "decode_partial_kernel"))


def served_kernel(name: str):
    """Which served-path kernel a device activity is, by its name: the
    integer core's instances by their template's NW (1: the fused matmul,
    2: the MLP), with f32 x (the codes matmul's x is int8)."""
    import re
    for kernel, part in SERVED_KERNEL_NAMES:
        if part in name:
            return kernel
    m = re.search(r"bp_mma_kernel<\s*\d+\s*,\s*[^,]+,\s*(\d+)\s*,"
                  r"\s*float", name)
    return None if m is None else {"1": "fused_matmul",
                                   "2": "fused_mlp"}.get(m.group(1))


def profile_serving(torch, engine, cfg, params, prompts, prompt_len=64,
                    new=8):
    """Device time by kernel, the card's idle share, and the host's
    ``paged.*`` ranges over a short serving run on ``engine`` (the prompts
    cut to ``prompt_len`` tokens, ``new`` new tokens each).  The run is
    served once unprofiled first, so that a capturing engine holds every
    graph it needs before the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cut = [p[:prompt_len] for p in prompts]
    serve(torch, cfg, params, cut, new, "cuda", engine)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s, _ = serve(torch, cfg, params, cut, new, "cuda", engine)
    rows, host = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("paged."):
            if ev.device_type != DeviceType.CUDA:   # (and its annotation
                host[ev.key] = {"ms": ev.cpu_time_total / 1e3,  # on the
                                "calls": ev.count}  # device: not a kernel)
            continue
        if ev.device_type != DeviceType.CUDA:
            continue        # host ops: their kernels are counted below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    out = {"capture": engine.capture, "wall_s": wall_s,
           "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_s,
           "host_ranges": {k: dict(v, share_of_wall=v["ms"] / 1e3 / wall_s)
                           for k, v in sorted(host.items())},
           "served_kernels": sorted({served_kernel(k) for _, k, _ in rows}
                                    - {None}),
           "top": [{"name": k[:120], "ms": us / 1e3, "calls": n,
                    "share_of_busy": us / 1e6 / busy_s}
                   for us, k, n in rows[:15]],
           # dtype casts and other copies (direct_copy_kernel)
           "copies": [{"name": k[:120], "ms": us / 1e3, "calls": n}
                      for us, k, n in rows if "copy" in k.lower()]}
    mode = "captured" if engine.capture else "eager"
    print(f"profile ({mode}): wall {wall_s:.3f}s, device busy "
          f"{busy_s:.3f}s, idle share {out['idle_share']:.3f}")
    for r in out["top"][:8]:
        print(f"  {r['share_of_busy']:.3f} {r['ms']:.1f} ms x{r['calls']} "
              f"{r['name']}")
    for r in out["copies"]:
        print(f"  copies: {r['ms']:.2f} ms x{r['calls']} {r['name'][:80]}")
    print("  host ranges (ms, share of wall): " + ", ".join(
        f"{k} {v['ms']:.1f} {v['share_of_wall']:.3f}"
        for k, v in out["host_ranges"].items()))
    return out


def decode_layer_launches(torch, cfg, params):
    """Device activities (kernels, memsets, copies) that one decode layer
    adds to a decode step of 4 rows, by kernel name, and their device
    time: the profile of a 3-layer step less that of a 2-layer step (same
    weights; ``params`` must hold 3 layers or more).  Each step is
    profiled twice and the second kept, so that the profiler's start-up
    loses nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build as build_model
    steps = []
    for layers in (2, 3):
        c = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(c)
        cache = model.init_cache(4, 256, "cuda")
        tokens = torch.ones((4, 1), dtype=torch.long, device="cuda")
        pos = torch.full((4,), 100, dtype=torch.int32, device="cuda")
        for _ in range(2):
            model.decode_step(params, tokens, cache, pos)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.decode_step(params, tokens, cache, pos)
                torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        steps.append(({e.key: e.count for e in evs},
                      sum(getattr(e, "self_device_time_total", 0) for e in evs)))
    (two, us2), (three, us3) = steps
    per = {k: three.get(k, 0) - two.get(k, 0) for k in set(two) | set(three)}
    per = {k: v for k, v in sorted(per.items(), key=lambda kv: -kv[1]) if v}
    total = sum(per.values())
    copies = sum(v for k, v in per.items() if "copy" in k.lower())
    print(f"decode layer launches: {total} device activities a layer "
          f"({copies} copy kernels), {(us3 - us2) / 1e3:.4f} ms of device "
          f"time; by kernel: "
          + ", ".join(f"{v} {k[:60]}" for k, v in per.items()))
    return {"total": total, "copies": copies, "by_kernel": per,
            "device_ms": (us3 - us2) / 1e3,
            "step_2_layers": sum(two.values()),
            "step_3_layers": sum(three.values())}


def phase_unfused(torch, timer, build, dev="cuda"):
    """The unfused pipeline at full width, with its periphery; returns the
    path's launch counts and a detail record."""
    from repro_torch.core.bp import bitstreams_bp8
    from repro_torch.kernels import bp_matmul as kb
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def weight(k, n):
        return randn(k, n, std=k ** -0.5).to(torch.bfloat16).float()

    ws = {kn: weight(*kn) for kn in dict.fromkeys(LAYER)}
    cases = [(randn(m, k), ws[(k, n)]) for m in (4, 256) for (k, n) in LAYER]
    m, k, n = QWEN_UP
    cases.append((randn(m, k), weight(k, n)))
    # periphery: 32 x 64 outputs over K = 256 (rows of 2048 signed bits)
    px, pw = randn(32, 256), weight(256, 64)
    tab_r, tab_l = (torch.as_tensor(bitstreams_bp8(w), dtype=torch.int8,
                                    device=dev) for w in ("right", "left"))
    # the same weights held as bf16, as the model holds them (exact: they
    # were rounded to bf16), read as stored by the unfused path too
    w16 = {id(w): w.to(torch.bfloat16) for _, w in cases}
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    outs = [ops.oisma_matmul(x, w, impl="unfused") for x, w in cases]
    outs16 = [ops.oisma_matmul(x, w16[id(w)], impl="unfused")
              for x, w in cases]
    xc = kb.bp_quantize(px, ref.tensor_scale(px))
    wc = kb.bp_quantize(pw, ref.tensor_scale(pw))
    bits = (tab_r[xc.abs().long()][:, :, None, :]
            * tab_l[wc.abs().long()][None]
            * (torch.sign(xc)[:, :, None] * torch.sign(wc)[None])[..., None])
    rows = bits.permute(0, 2, 1, 3).reshape(32 * 64, 256 * 8).contiguous()
    periphery = ops.popcount_accumulate(rows).reshape(32, 64)
    product = ops.bp_matmul_codes(xc, wc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    for (x, w), a, a16 in zip(cases, outs, outs16):
        b = ops.oisma_matmul(x, w)
        if not torch.equal(a, b):
            fail(f"unfused != fused at {tuple(x.shape)} @ {tuple(w.shape)}: "
                 f"max {(a - b).abs().max().item()}")
        # the served form: the same weight held as bf16 (it is exact there)
        if not torch.equal(a, ops.oisma_matmul(x, w16[id(w)])):
            fail(f"unfused != fused with a bf16 weight at {tuple(x.shape)} "
                 f"@ {tuple(w.shape)}")
        if not torch.equal(a16, b):
            fail(f"unfused with a bf16 weight != fused at {tuple(x.shape)} "
                 f"@ {tuple(w.shape)}: max {(a16 - b).abs().max().item()}")
    if not torch.equal(periphery.to(torch.float32), product):
        fail("periphery popcounts differ from the codes matmul")
    layer = {}
    for m in (4, 256):
        pairs = [(x, w) for x, w in cases[:-1] if x.shape[0] == m]
        layer[m] = dict(
            unfused_ms=timer([lambda x=x, w=w: ops.oisma_matmul(
                x, w, impl="unfused") for x, w in pairs]),
            unfused_bf16_weights_ms=timer([lambda x=x, w=w16[id(w)]:
                                           ops.oisma_matmul(
                                               x, w, impl="unfused")
                                           for x, w in pairs]),
            fused_ms=timer([lambda x=x, w=w: ops.oisma_matmul(x, w)
                            for x, w in pairs]))
    x, w = cases[-1]
    qwen = dict(unfused_ms=timer([lambda: ops.oisma_matmul(
        x, w, impl="unfused")], iters=3),
        fused_ms=timer([lambda: ops.oisma_matmul(x, w)], iters=3))
    qs = "x".join(map(str, QWEN_UP))
    print(f"unfused path: {len(cases)} matmuls (7 per layer at M 4 and 256, "
          f"qwen2-72b {qs}), each with an f32 and a bf16 weight, + "
          f"periphery in {wall:.3f}s, all equal to the fused path bitwise; "
          f"launches {launches}")
    for m, r in layer.items():
        was = (f" ({EARLIER}: {EARLIER_MS['fused_layer_256_rows_ms']})"
               if m == 256 else "")
        print(f"  one layer, M {m}: unfused {r['unfused_ms']:.4f} ms (bf16 "
              f"weights {r['unfused_bf16_weights_ms']:.4f}), fused "
              f"{r['fused_ms']:.4f} ms{was}")
    print(f"  qwen2-72b {qs}: unfused {qwen['unfused_ms']:.4f} ms, fused "
          f"{qwen['fused_ms']:.4f} ms ({EARLIER}: "
          f"{EARLIER_MS['qwen2_72b_fused_ms']})")
    return launches, {"wall_s": wall, "launches": launches,
                      "layer_ms": layer, f"qwen2_72b_{qs}_ms": qwen}


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name: str, report: dict):
        self.name, self.report = name, report

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.report.setdefault("phase_s", {})[self.name] = dt
        print(f"phase {self.name}: {dt:.1f}s")


def card_vs_cpu(torch, cfg, prompts):
    """The same seeded 2-layer weights on the card, captured and eager, and
    on the CPU must emit the same greedy tokens."""
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params, tree_map
    p_cpu = init_params(build_model(cfg).schema(), seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to("cuda"), p_cpu)
    out_gpu, _, eng = serve(torch, cfg, p_gpu, prompts, 8, "cuda")
    if not eng.capture:
        fail("the engine on CUDA does not capture by default")
    out_eager, _, _ = serve(torch, cfg, p_gpu, prompts, 8, "cuda",
                            capture=False)
    out_cpu, cpu_s, _ = serve(torch, cfg, p_cpu, prompts, 8, "cpu")
    print(f"card vs cpu ({cfg.matmul_mode}, 2 layers, full width): card, "
          f"captured ({eng.compile_counts()} graphs) {out_gpu}")
    print(f"    card, eager {out_eager}")
    print(f"    cpu {out_cpu} ({cpu_s:.1f}s on the CPU)")
    if out_gpu != out_eager:
        fail(f"{cfg.matmul_mode}: captured and eager tokens differ")
    if out_gpu != out_cpu:
        fail(f"{cfg.matmul_mode}: card and CPU paths emit different tokens")
    return cpu_s


def graphed_vs_eager(torch, model, params, rng):
    """A prefill chunk (64 tokens at position 64) and a decode step (4 rows)
    at full width, replayed from graphs, against the eager calls on the
    same inputs: the caches bitwise equal, and the logits bitwise equal
    (or, if the f32 logits matmul alone differs under capture, that is
    printed with its largest difference)."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve.graphs import GraphedEntry
    cfg = model.cfg

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    def caches_equal(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y)
                   in zip(tree_leaves(a), tree_leaves(b)))

    pool = torch.cuda.graph_pool_handle()
    prefill = GraphedEntry(lambda t, v, p0: model.prefill_chunk(
        params, {"tokens": t}, v, p0), capture=True, pool=pool)
    decode = GraphedEntry(lambda t, v, p: model.decode_step(params, t, v, p),
                          capture=True, pool=pool)
    cache = model.init_cache(1, 256, "cuda")
    model.prefill_chunk(params, {"tokens": torch.as_tensor(rng.integers(
        3, cfg.vocab_size, (1, 64)), device="cuda")}, cache, 0)
    t = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, 64)),
                        device="cuda")
    prefill.inputs("p", lambda: (t.clone(), clone(cache),
                                 torch.full((), 64, device="cuda")))
    want, want_cache = model.prefill_chunk(params, {"tokens": t},
                                           clone(cache), 64)
    got, got_cache = prefill("p")
    # a graph's outputs live in the shared pool until another graph runs
    result = {"prefill chunk 64": (got.clone(), want, got_cache,
                                   want_cache)}
    rows = 4
    full = {"layers": {k: v.expand(-1, rows, *v.shape[2:]).contiguous()
                       for k, v in want_cache["layers"].items()}}
    t = torch.as_tensor(rng.integers(3, cfg.vocab_size, (rows, 1)),
                        device="cuda")
    p = torch.tensor([128, 130, 200, 255], dtype=torch.int32, device="cuda")
    decode.inputs("d", lambda: (t.clone(), clone(full), p.clone()))
    want, want_cache = model.decode_step(params, t, clone(full), p)
    got, got_cache = decode("d")
    result["decode step 4 rows"] = (got.clone(), want, got_cache,
                                    want_cache)
    report = {}
    for what, (g, w, gc, wc) in result.items():
        if not caches_equal(gc, wc):
            fail(f"graphed {what}: the cache differs from the eager call's")
        diff = (g - w).abs().max().item()
        report[what] = {"logits_bitwise": bool(torch.equal(g, w)),
                        "logits_max_abs_diff": diff}
        if not torch.equal(g, w):
            h = torch.randn((g.shape[0], cfg.d_model),
                            device="cuda").to(torch.bfloat16)
            mm = GraphedEntry(lambda h: model._logits(params, h),
                              capture=True, pool=pool)
            mm.inputs("h", lambda: (h.clone(),))
            alone = (mm("h") - model._logits(params, h)).abs().max().item()
            if alone == 0.0:
                fail(f"graphed {what}: logits differ by {diff} with the "
                     f"caches equal and the logits matmul alone equal")
            print(f"graphed {what}: logits differ by at most {diff:.3g}; "
                  f"cause: the f32 logits matmul alone differs under "
                  f"capture by {alone:.3g} (cuBLAS)")
            report[what]["cause"] = "f32 logits matmul under capture"
    print(f"graphed vs eager at full width: {report}")
    return report


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs one NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params

    resolve_device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    with Phase("1 build", report):
        lib_path = build.build()
        log = (lib_path.parent / build.LOG_NAME).read_text()
        report["build_log"] = log
        for line in ptxas_report(log):
            print(f"ptxas: {line}")
        sass = sass_counts(build, lib_path)
        report["bp_mma_sass"] = sass
        for fn, c in sass.items():
            print(f"SASS {fn}: {c['IMMA']} IMMA, {c['IGMMA']} IGMMA, "
                  f"{c['POPC']} POPC")
        for ctx in next(iter(sass.values()), {}).get("POPC_context", []):
            print(f"  POPC in context: {' | '.join(ctx)}")
        if not sass or any(c["IMMA"] + c["IGMMA"] == 0 for c in sass.values()):
            fail("the integer core's kernels must multiply on the int8 "
                 "tensor cores (IMMA or IGMMA)")
        # the codes matmul: coded x and one coded weight (x's type last)
        if not any("Li1EaEE" in fn for fn in sass):
            fail("no kernel of the codes matmul in the SASS")
        lib = build.library()
        from repro_torch.kernels.attention import _split_smem
        print("dynamic shared memory: fused matmul tiles (bf16 weight) "
              + ", ".join(f"M {m}: {lib.oisma_fused_matmul_smem(m, 1)} B"
                          for m in (4, 64, 256))
              + f"; decode attention split block (G 4, D 80, 64 tokens) "
              f"{_split_smem(4, 80, 64)} B")
    print(f"kernels built ({build.BUILD_ROOT / build.source_hash()})")

    # ---- phase 2: kernels vs plain ----
    with Phase("2 kernels vs plain", report):
        timer = Timer(torch)
        rows, detail = phase_kernels(torch, timer)
    report["kernel_detail"] = detail
    for name, r in rows.items():
        was = (f" ({EARLIER}: {EARLIER_MS[name]})" if name in EARLIER_MS
               else "")
        print(f"kernel {name}: ms {r['ms']:.4f}{was} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} max_abs_err "
              f"{r['max_abs_err']}")
    for k, v in detail.items():
        if k.endswith("_ms"):
            was = (f" ({EARLIER}: {EARLIER_MS[k]})" if k in EARLIER_MS
                   else "")
            print(f"  {k}: {v:.4f}{was}")
        elif k.endswith("_kernels_per_call"):
            print(f"  {k}: {v}")

    # ---- phase 3: card vs CPU at full width, 2 layers ----
    rng = np.random.default_rng(0)
    full = dataclasses.replace(get_config("h2o_danube_1p8b"),
                               matmul_mode="bp8_fused", kv_quant="bp8")
    prompts = [rng.integers(3, full.vocab_size, n).astype(np.int32)
               for n in (37, 64, 101)]
    report["cpu_s"] = {}
    for mode in ("bp8_fused", "bp8"):
        with Phase(f"3 card vs cpu, {mode}", report):
            cfg2 = dataclasses.replace(full, num_layers=2, matmul_mode=mode)
            report["cpu_s"][mode] = card_vs_cpu(torch, cfg2, prompts)

    # ---- phase 4: the served path, full model ----
    with Phase("4 served path (bp8_fused)", report):
        model = build_model(full)
        params = init_params(model.schema(), seed=0, device="cuda")
        lens = [32, 256] + [int(n) for n in rng.integers(32, 257, 6)]
        prompts = [rng.integers(3, full.vocab_size, n).astype(np.int32)
                   for n in lens]
        # captured: the first run captures each shape's graph, the second
        # (timed, launches counted) replays them
        torch.cuda.reset_peak_memory_stats()
        cold, cold_s, engine = serve(torch, full, params, prompts, 16, "cuda")
        capture_s = engine.stats.snapshot()["capture_s"]
        before = engine.stats.snapshot()
        build.reset_launches()
        out, dt, _ = serve(torch, full, params, prompts, 16, "cuda", engine)
        launches = dict(build.LAUNCHES)
        run = {k: engine.stats.snapshot()[k] - before[k]
               for k in ("steps", "prefill_chunks", "decode_ticks")}
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts, bounds = engine.compile_counts(), engine.compile_shape_bounds()
        # eager, on an engine of its own, after a short warm-up
        torch.cuda.reset_peak_memory_stats()
        eager_engine = make_engine(full, params, "cuda", capture=False)
        serve(torch, full, params, prompts[:1], 2, "cuda", eager_engine)
        eager, eager_s, _ = serve(torch, full, params, prompts, 16, "cuda",
                                  eager_engine)
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        n_tok = sum(len(v) for v in out.values())
        print(f"served path: {full.name} {full.num_layers} layers, "
              f"{len(out)} requests (prompts {lens}), {n_tok} tokens; "
              f"captured, warm: {dt:.3f}s = {n_tok / dt:.2f} tok/s; eager: "
              f"{eager_s:.3f}s = {n_tok / eager_s:.2f} tok/s; captured, "
              f"first run {cold_s:.3f}s of which warm-ups and captures "
              f"{capture_s:.3f}s; engine steps a run {run['steps']}, "
              f"prefill chunks {run['prefill_chunks']}, decode ticks "
              f"{run['decode_ticks']}")
        print(f"graphs per entry point {counts}, bound "
              f"{bounds}; peak device memory captured {peak:.2f} GB, "
              f"eager {eager_peak:.2f} GB")
        print(f"served path launches (warm captured run, replays "
              f"counted): {launches}")
        if any(counts[k] > bounds[k] for k in bounds):
            fail(f"graphs {counts} exceed the bound {bounds}")
        if not out == cold == eager:
            fail("captured (first and second run) and eager tokens differ")
        for name, path in PATHS.items():
            if path == "serve_bp8_fused" and launches.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the served path")
        for rid, toks in out.items():
            if len(toks) != 16 or not all(0 <= t < full.vocab_size
                                          for t in toks):
                fail(f"request {rid}: bad output {toks}")
        logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
            prompts[0][None, :16].astype(np.int64), device="cuda")}, 16)
        if logits.shape != (1, full.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        report["graphed_vs_eager"] = graphed_vs_eager(torch, model, params,
                                                      rng)
        report["profile"] = profile_serving(torch, engine, full, params,
                                            prompts[:4])
        report["profile_eager"] = profile_serving(torch, eager_engine, full,
                                                  params, prompts[:4])
        ran = set(report["profile"]["served_kernels"])
        for name, path in PATHS.items():
            if path == "serve_bp8_fused" and name not in ran:
                fail(f"kernel {name} does not run in the captured profile "
                     f"(ran: {sorted(ran)})")
        del eager_engine
        report["decode_layer_launches"] = decode_layer_launches(
            torch, full, params)
        report["main_path"] = {
            "model": full.name, "layers": full.num_layers,
            "requests": len(out), "prompt_lens": lens, "new_tokens": n_tok,
            "seconds": dt, "tokens_per_s": n_tok / dt,
            "eager_seconds": eager_s, "eager_tokens_per_s": n_tok / eager_s,
            "first_run_seconds": cold_s, "capture_s": capture_s,
            "graphs": counts, "graph_bounds": bounds,
            "engine_steps": run["steps"],
            "prefill_chunks": run["prefill_chunks"],
            "decode_ticks": run["decode_ticks"],
            "launches": launches, "peak_mem_gb": peak,
            "eager_peak_mem_gb": eager_peak}
        del engine

    # ---- phase 5: the unfused pipeline at full width ----
    with Phase("5 unfused path", report):
        unfused_launches, report["unfused_path"] = phase_unfused(
            torch, timer, build)
        for name, path in PATHS.items():
            if path == "unfused" and unfused_launches.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the unfused path")

    # ---- phase 6: full depth in bp8 ----
    with Phase("6 full depth, bp8", report):
        full8 = dataclasses.replace(full, matmul_mode="bp8")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, engine = serve(torch, full8, params, prompts[:2], 8, "cuda")
        first_s = time.perf_counter() - t0
        capture_s = engine.stats.snapshot()["capture_s"]
        out, dt, _ = serve(torch, full8, params, prompts[:2], 8, "cuda",
                           engine)
        n_tok = sum(len(v) for v in out.values())
        peak = torch.cuda.max_memory_allocated() / 1e9
        for rid, toks in out.items():
            if len(toks) != 8 or not all(0 <= t < full.vocab_size
                                         for t in toks):
                fail(f"bp8 request {rid}: bad output {toks}")
        print(f"bp8 full depth: {full8.num_layers} layers, 2 requests "
              f"(prompts {lens[:2]}), {n_tok} tokens, captured, warm: "
              f"{dt:.3f}s = {n_tok / dt:.2f} tok/s (first run {first_s:.3f}s,"
              f" of which warm-ups and captures {capture_s:.3f}s), engine "
              f"steps {engine.step_count // 2}, graphs "
              f"{engine.compile_counts()}, peak device memory {peak:.2f} GB")
        report["bp8_full_depth"] = {
            "seconds": dt, "first_run_s": first_s, "capture_s": capture_s,
            "new_tokens": n_tok, "tokens_per_s": n_tok / dt,
            "engine_steps": engine.step_count // 2, "peak_mem_gb": peak,
            "profile": profile_serving(torch, engine, full8, params,
                                       prompts[:1], 16, 2)}
        del engine

    path_launches = {"serve_bp8_fused": launches, "unfused": unfused_launches}
    kernels = []
    for name in SOURCES:
        r = rows[name]
        b = r["b"]
        t_bytes = sum(x[1] for x in b)
        t_ops = sum(x[2] for x in b)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "path": PATHS[name],
            "launches": path_launches[PATHS[name]][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": sum(x[0] for x in b),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"]})
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
