"""Analytic device-memory traffic of the fused and unfused kernel paths.

The reference's bytes-moved model (``repro/kernels/traffic.py``), with
the same functions, term names and ``assert_no_roundtrip``.  Every
function returns ``{"terms": {name: bytes}, "total": bytes,
"padded_elements": n}`` with one named term per memory stream, so a test
can assert *structurally* that the fused schedule has no quantisation
round-trip: no ``*_codes_write`` term, no rescale read-modify-write, and
never an 8x bitplane term.

Tiling model: a grid (M/bm, N/bn, K/bk) with the output tile resident
across K, so the x panel is read once per N tile (``n_n`` times) and the
weight panel once per M tile (``n_m`` times).  Shapes are padded to the
block grid before counting, as the reference's kernels pad (the port's
kernels mask their edges instead; the padding is reported as its own
number).  The blocks are arguments with no default: the port's callers
pass the tile of the Hopper kernels (``hopper_tiles``), and the same
blocks give the reference's dicts.
"""
from __future__ import annotations

from typing import Dict

F32 = 4
BF16 = 2
INT8 = 1


def hopper_tiles(m: int, weights: int = 1) -> Dict[str, int]:
    """The tile of the integer core (``csrc/bp_mma.cuh``) at ``m`` rows
    with one weight (the fused matmul, the codes matmul) or two (the fused
    MLP): rows by ``rows_per_block``, columns ``Cfg::kBN``, depth
    ``kBK``."""
    bm = 16 if m <= 16 else 64 if m <= 64 else 128
    bn = 64 if weights == 2 and bm > 16 else 128
    return {"block_m": bm, "block_n": bn, "block_k": 16}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _blocks(m, k, n, block_m, block_n, block_k):
    bm = min(block_m, _ceil_to(m, 8))
    bn = min(block_n, _ceil_to(n, 128))
    bk = min(block_k, _ceil_to(k, 128))
    mp, kp, np_ = _ceil_to(m, bm), _ceil_to(k, bk), _ceil_to(n, bn)
    return mp, kp, np_, mp // bm, np_ // bn


def matmul_traffic_unfused(m: int, k: int, n: int, *, block_m: int,
                           block_n: int, block_k: int) -> Dict:
    """``oisma_matmul(impl="unfused")``: quantise both operands (read
    f32, write int8 codes), the codes matmul (x panel read n_n times, y
    panel n_m times), then the rescale pass (read the integer
    accumulation, write the scaled output)."""
    mp, kp, np_, n_m, n_n = _blocks(m, k, n, block_m, block_n, block_k)
    terms = {
        "x_quantize_read_f32": m * k * F32,
        "x_codes_write": m * k * INT8,
        "y_quantize_read_f32": k * n * F32,
        "y_codes_write": k * n * INT8,
        "x_codes_read_matmul": mp * kp * INT8 * n_n,
        "y_codes_read_matmul": kp * np_ * INT8 * n_m,
        "acc_write": mp * np_ * F32,
        "rescale_read": m * n * F32,
        "rescale_write": m * n * F32,
    }
    return {"terms": terms, "total": sum(terms.values()),
            "padded_elements": (mp * kp - m * k) + (kp * np_ - k * n)}


def matmul_traffic_fused(m: int, k: int, n: int, *, block_m: int,
                         block_n: int, block_k: int,
                         weights_coded: bool = True) -> Dict:
    """The fused schedule: one absmax scan over each fresh operand, then
    one kernel that reads raw tiles, encodes them on chip and writes the
    rescaled output once.  ``weights_coded``: the weight is held as int8
    codes (``prepare_bp_weight``, encoded once), so the kernel streams
    1-byte codes; otherwise the real weight panel is read and encoded in
    the kernel, counted at 4 bytes an element."""
    mp, kp, np_, n_m, n_n = _blocks(m, k, n, block_m, block_n, block_k)
    terms = {
        "x_absmax_read_f32": m * k * F32,
        "x_read_matmul_f32": mp * kp * F32 * n_n,
        "out_write": m * n * F32,
    }
    if weights_coded:
        terms["w_codes_read_matmul"] = kp * np_ * INT8 * n_m
    else:
        terms["y_absmax_read_f32"] = k * n * F32
        terms["y_read_matmul_f32"] = kp * np_ * F32 * n_m
    return {"terms": terms, "total": sum(terms.values()),
            "padded_elements": (mp * kp - m * k) + (kp * np_ - k * n)}


def mlp_traffic_unfused(m: int, k: int, f: int, *, block_m: int,
                        block_n: int, block_k: int) -> Dict:
    """Two independent unfused matmul pipelines (up and gate: the
    activation is quantised twice) plus the act(gate) * up pass over the
    two materialised (M, F) projections."""
    up = matmul_traffic_unfused(m, k, f, block_m=block_m, block_n=block_n,
                                block_k=block_k)
    terms = {f"up_{t}": v for t, v in up["terms"].items()}
    terms.update({f"gate_{t}": v for t, v in up["terms"].items()})
    terms["act_mul_read"] = 2 * m * f * F32
    terms["act_mul_write"] = m * f * F32
    return {"terms": terms, "total": sum(terms.values()),
            "padded_elements": 2 * up["padded_elements"]}


def mlp_traffic_fused(m: int, k: int, f: int, *, block_m: int,
                      block_n: int, block_k: int,
                      weights_coded: bool = True) -> Dict:
    """One absmax scan over the activation; one kernel streaming the x
    panel once per F tile and both weight panels once per M tile; the
    (M, F) projections live only on chip: one output write."""
    mp, kp, fp, n_m, n_f = _blocks(m, k, f, block_m, block_n, block_k)
    terms = {
        "x_absmax_read_f32": m * k * F32,
        "x_read_matmul_f32": mp * kp * F32 * n_f,
        "out_write": m * f * F32,
    }
    wsize = INT8 if weights_coded else F32
    terms["up_w_read"] = kp * fp * wsize * n_m
    terms["gate_w_read"] = kp * fp * wsize * n_m
    if not weights_coded:
        terms["up_absmax_read_f32"] = k * f * F32
        terms["gate_absmax_read_f32"] = k * f * F32
    return {"terms": terms, "total": sum(terms.values()),
            "padded_elements": (mp * kp - m * k) + 2 * (kp * fp - k * f)}


def decode_attention_traffic(b: int, s: int, kh: int, g: int, d: int, *,
                             kv_dtype_bytes: int = BF16) -> Dict[str, Dict]:
    """Per decode step, per layer: the KV streams dominate.

    ``unfused``: the cache holds ``kv_dtype_bytes``-wide k/v (bf16 in
    this repo; 4 for an f32 cache) and every step reads both in full.
    ``fused``: the cache holds int8 codes + one f32 scale per (token,
    head); the kernel reads codes and scales and dequantises on chip.
    The same ratio applies to the paged engine's gathered views: the
    gather copies whatever the pool stores.
    """
    q_bytes = b * kh * g * d * F32
    unfused = {
        "q_read": q_bytes,
        "kv_read": 2 * b * s * kh * d * kv_dtype_bytes,
        "out_write": q_bytes,
    }
    fused = {
        "q_read": q_bytes,
        "kv_codes_read": 2 * b * s * kh * d * INT8,
        "kv_scales_read": 2 * b * s * kh * F32,
        "out_write": q_bytes,
    }
    return {
        "unfused": {"terms": unfused, "total": sum(unfused.values()),
                    "padded_elements": 0},
        "fused": {"terms": fused, "total": sum(fused.values()),
                  "padded_elements": 0},
    }


def assert_no_roundtrip(traffic: Dict) -> None:
    """The structural no-round-trip property of a fused accounting."""
    for name in traffic["terms"]:
        assert "codes_write" not in name, name
        assert "rescale" not in name, name
        assert "bitplane" not in name, name
        assert "quantize" not in name, name
