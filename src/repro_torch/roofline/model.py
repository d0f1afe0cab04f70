"""Analytic roofline cost model for every (architecture x shape) cell.

A copy of the reference's ``repro/roofline/model.py`` (the same formulas
in the same order, so every count equals the reference's), reading the
port's configs, schemas, ``models.ssm.mlstm_inner``,
``core.bp_matmul.lut_rank`` and ``sim``.  The terms are divided by the
H100's peaks in ``roofline.analysis``.  The reference made the model
analytic because XLA's ``cost_analysis()`` counts a rolled loop's body
once; the port's own check is ``torch.utils.flop_counter`` on one layer
(``tests/test_torch_roofline.py``).

All formulas count matmul FLOPs as 2mnk; elementwise work is ignored
(<1% for these shapes).  Traffic formulas are stated next to each term.
``SINGLE_POD``/``MULTI_POD`` are the reference's production meshes, kept
as data for parity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One mesh axis: its name, size, and what the formulas use it for.

    ``role`` drives every derived quantity, so a new axis is data, not a
    hand-edit: "batch" axes multiply into ``dp``, "tensor" and "stage"
    axes into ``weight_shards``, "sequence" axes ring the KV cache.
    """
    name: str
    size: int
    role: str      # "batch" | "tensor" | "stage" | "sequence"


#: Canonical roles of the production axis names (``launch/mesh.py``).
AXIS_ROLES = {"pod": "batch", "data": "batch", "model": "tensor",
              "stage": "stage", "seq": "sequence"}


@dataclasses.dataclass(frozen=True, init=False)
class MeshSpec:
    """Declarative mesh description: an ordered tuple of :class:`MeshAxis`.

    The historical keyword/positional constructor
    ``MeshSpec(pod, data, model, stage=1, seq=1)`` is preserved — it
    builds the canonical five-axis tuple (size-1 axes included, so
    equality between old-style and explicit constructions holds) — and
    ``from_axes`` admits arbitrary axis lists for future geometries.
    Dry-run records and ``scripts/check_results.py`` only ever see the
    derived scalars, so their schemas are unchanged.
    """
    axes: Tuple[MeshAxis, ...]

    def __init__(self, pod: int = 1, data: int = 1, model: int = 1,
                 stage: int = 1, seq: int = 1,
                 axes: Optional[Tuple[MeshAxis, ...]] = None):
        if axes is None:
            axes = tuple(MeshAxis(n, s, AXIS_ROLES[n]) for n, s in
                         (("pod", pod), ("stage", stage), ("seq", seq),
                          ("data", data), ("model", model)))
        else:
            axes = tuple(axes)
            names = [a.name for a in axes]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate mesh axis names: {names}")
        object.__setattr__(self, "axes", axes)

    @classmethod
    def from_axes(cls, axes) -> "MeshSpec":
        """Build from an iterable of MeshAxis or (name, size, role) triples."""
        return cls(axes=tuple(a if isinstance(a, MeshAxis) else MeshAxis(*a)
                              for a in axes))

    def axis_size(self, name: str) -> int:
        """Size of the named axis (1 if absent — absent = unsharded)."""
        return next((a.size for a in self.axes if a.name == name), 1)

    def role_size(self, *roles: str) -> int:
        """Product of the sizes of every axis with one of ``roles``."""
        out = 1
        for a in self.axes:
            if a.role in roles:
                out *= a.size
        return out

    # -- named views the formulas (and dry-run stamps) read --------------
    @property
    def pod(self) -> int:
        return self.axis_size("pod")

    @property
    def data(self) -> int:
        return self.axis_size("data")

    @property
    def model(self) -> int:
        return self.axis_size("model")

    @property
    def stage(self) -> int:
        return self.axis_size("stage")

    @property
    def seq(self) -> int:
        return self.axis_size("seq")

    @property
    def chips(self) -> int:
        return self.role_size("batch", "tensor", "stage", "sequence")

    @property
    def dp(self) -> int:  # total data-parallel ways
        return self.role_size("batch")

    @property
    def weight_shards(self) -> int:
        """TP-orthogonal weight sharding ways: the tensor axes, times the
        stage axes when pipelined (each stage holds only its layer block —
        the TP-in-stage layout the pipelined train step executes)."""
        return self.role_size("tensor", "stage")


SINGLE_POD = MeshSpec(pod=1, data=16, model=16)
MULTI_POD = MeshSpec(pod=2, data=16, model=16)


# ---------------------------------------------------------------------------
# per-token forward FLOPs by family
# ---------------------------------------------------------------------------

def _attn_flops_per_tok(cfg: ModelConfig, kv_len: float) -> float:
    """QKVO projections + score/value contractions for ONE query token."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention_type == "mla":
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        proj = 2 * d * (cfg.q_lora_rank or d)
        if cfg.q_lora_rank:
            proj += 2 * cfg.q_lora_rank * h * qk
        proj += 2 * d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        # k/v expansion from the latent (train/prefill) — or the absorbed
        # q/out projections (decode); either way 2 x lora x h x dims
        proj += 2 * cfg.kv_lora_rank * h * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        proj += 2 * h * cfg.v_head_dim * d
        sc = 2 * h * qk * kv_len + 2 * h * cfg.v_head_dim * kv_len
        return proj + sc
    proj = 2 * d * h * hd + 2 * 2 * d * kh * hd + 2 * h * hd * d
    sc = 2 * 2 * h * hd * kv_len
    return proj + sc


def _mlp_flops_per_tok(cfg: ModelConfig) -> float:
    mults = 3 if cfg.mlp_gated else 2
    return 2 * mults * cfg.d_model * cfg.d_ff


def _moe_flops_per_tok(cfg: ModelConfig) -> float:
    act = cfg.num_experts_per_tok + cfg.num_shared_experts
    return (2 * 3 * cfg.d_model * cfg.moe_d_ff * act
            + 2 * cfg.d_model * cfg.num_experts)


def _mamba_flops_per_tok(cfg: ModelConfig, chunk: int = 256) -> float:
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    proj = 2 * cfg.d_model * (2 * di + 2 * n + di // cfg.ssm_headdim)
    # SSD: B/C contractions (2*di*n each) + intra-chunk quadratic (~2*di*Q)
    ssd = 2 * di * n * 2 + 2 * di * chunk
    out = 2 * di * cfg.d_model
    return proj + ssd + out


def _mlstm_flops_per_tok(cfg: ModelConfig, chunk: int = 256) -> float:
    from repro_torch.models.ssm import mlstm_inner
    di = mlstm_inner(cfg)
    dk = di // cfg.num_heads
    up = 2 * cfg.d_model * 2 * di
    qkv = 2 * 3 * di * dk
    # chunkwise cell: intra-chunk quadratic (2*Q*(dk+dv) per tok) + state ops
    cell = 2 * chunk * 2 * dk * cfg.num_heads + 2 * 2 * dk * dk * cfg.num_heads
    down = 2 * di * cfg.d_model
    return up + qkv + cell + down


def _slstm_flops_per_tok(cfg: ModelConfig) -> float:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    return 2 * d * 4 * d + 2 * 4 * h * hd * hd + 2 * d * d


def _layer_eff_kv(cfg: ModelConfig, layer_idx: int, kv_len: float) -> float:
    """Effective attended kv length of one layer under SWA/local-global."""
    if cfg.local_global_pattern:
        per = cfg.local_global_pattern + 1
        if (layer_idx % per) == per - 1:
            return kv_len
        return min(kv_len, cfg.window_size or kv_len)
    if cfg.window_size:
        return min(kv_len, cfg.window_size)
    return kv_len


def fwd_flops_per_layer_tok(cfg: ModelConfig, layer_idx: int,
                            kv_len: float) -> float:
    if cfg.family == "xlstm":
        per = cfg.slstm_every
        if (layer_idx % per) == per - 1:
            return _slstm_flops_per_tok(cfg)
        return _mlstm_flops_per_tok(cfg)
    if cfg.family == "hybrid":
        return _mamba_flops_per_tok(cfg)  # shared attn handled separately
    # decoder/encdec transformer layer
    a = _attn_flops_per_tok(cfg, _layer_eff_kv(cfg, layer_idx, kv_len))
    if cfg.num_experts and layer_idx >= cfg.first_dense_layers:
        return a + _moe_flops_per_tok(cfg)
    return a + _mlp_flops_per_tok(cfg)


def fwd_flops_per_token(cfg: ModelConfig, kv_len: float,
                        avg_q_len: Optional[float] = None) -> float:
    """Forward FLOPs for one (decoder) token.

    For train/prefill over a sequence of length S, causal attention sees an
    average kv_len of (S+1)/2 — pass avg_q_len=S and kv_len=S.
    """
    eff_kv = (kv_len + 1) / 2 if avg_q_len else kv_len
    total = sum(fwd_flops_per_layer_tok(cfg, i, eff_kv)
                for i in range(cfg.num_layers))
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
        total += n_attn * (_attn_flops_per_tok(cfg, eff_kv)
                           + _mlp_flops_per_tok(cfg)
                           + 2 * 2 * cfg.d_model * cfg.lora_rank)
    total += 2 * cfg.d_model * cfg.vocab_size  # logits
    return total


def _encoder_flops(cfg: ModelConfig, batch: int) -> float:
    """whisper encoder over the (stub-embedded) frames."""
    if cfg.family != "encdec":
        return 0.0
    f = cfg.encoder_frames
    per_tok = (_attn_flops_per_tok(cfg, f) + _mlp_flops_per_tok(cfg))
    return batch * f * per_tok * cfg.encoder_layers


def _cross_attn_flops(cfg: ModelConfig, tokens: float) -> float:
    if cfg.family != "encdec":
        return 0.0
    d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.encoder_frames
    per_tok = 2 * d * h * hd * 2 + 2 * 2 * h * hd * f  # q,o + scores/values
    return tokens * per_tok * cfg.num_layers


def _attn_quad_flops_per_tok(cfg: ModelConfig, kv_len: float) -> float:
    """Just the score/value contractions (NOT routed through dense())."""
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.family in ("xlstm", "hybrid"):
            continue
        eff = _layer_eff_kv(cfg, i, kv_len)
        if cfg.attention_type == "mla":
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            total += 2 * cfg.num_heads * (qk + cfg.v_head_dim) * eff
        else:
            total += 2 * 2 * cfg.num_heads * cfg.head_dim * eff
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
        total += n_attn * 2 * 2 * cfg.num_heads * cfg.head_dim * kv_len
    return total


def matmul_mode_mult(cfg: ModelConfig) -> float:
    """FLOP multiplier for dense()-routed matmuls under the active mode.

    bp8 bitplane: 8x inner-dim expansion; bp8_lowrank: rank(LUT)-wide.
    MoE expert einsums and attention contractions stay native (bf16)."""
    if cfg.matmul_mode == "bp8":
        return 8.0
    if cfg.matmul_mode == "bp8_lowrank":
        from repro_torch.core.bp_matmul import lut_rank
        return float(lut_rank())
    return 1.0


def cell_flops(cfg: ModelConfig, shape: ShapeConfig, remat: bool = True,
               mm_mult: Optional[float] = None) -> Dict[str, float]:
    """Total HLO-equivalent FLOPs for one step of this cell.

    Under bp8 modes the *forward* (and remat re-forward) dense matmuls blow
    up by ``mm_mult``; the STE backward runs native bf16 (2x fwd)."""
    b, s = shape.global_batch, shape.seq_len
    prefix = cfg.num_prefix_tokens
    if mm_mult is None:
        mm_mult = matmul_mode_mult(cfg)
    kv = s + prefix

    def fwd_tokens(tokens, avg):
        base = tokens * fwd_flops_per_token(cfg, kv, avg_q_len=avg)
        base += _encoder_flops(cfg, b) + _cross_attn_flops(
            cfg, tokens if shape.kind != "decode" else b)
        if mm_mult == 1.0:
            return base, base
        eff = (kv + 1) / 2 if avg else kv
        other = tokens * (_attn_quad_flops_per_tok(cfg, eff)
                          + 2 * cfg.d_model * cfg.vocab_size)
        if cfg.num_experts:  # expert einsums stay native
            act = cfg.num_experts_per_tok + cfg.num_shared_experts
            moe_layers = cfg.num_layers - cfg.first_dense_layers
            other += tokens * moe_layers * 2 * 3 * cfg.d_model * \
                cfg.moe_d_ff * act
        mm = base - other
        return mm * mm_mult + other, base

    if shape.kind == "train":
        tokens = b * (s + prefix)
        fwd_eff, fwd_base = fwd_tokens(tokens, avg=s)
        refwd = fwd_eff if remat else 0.0
        total = fwd_eff + 2.0 * fwd_base + refwd  # fwd + bwd(STE bf16) + remat
        return {"total": total, "fwd": fwd_eff,
                "mult": total / fwd_base if fwd_base else 0.0}
    if shape.kind == "prefill":
        tokens = b * (s + prefix)
        fwd_eff, _ = fwd_tokens(tokens, avg=s)
        return {"total": fwd_eff, "fwd": fwd_eff, "mult": 1.0}
    # decode: one token against a cache of length s
    fwd_eff, _ = fwd_tokens(b, avg=None)
    return {"total": fwd_eff, "fwd": fwd_eff, "mult": 1.0}


# ---------------------------------------------------------------------------
# HBM traffic
# ---------------------------------------------------------------------------

def param_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    from repro_torch.models import build
    from repro_torch.models.params import param_count
    return param_count(build(cfg).schema()) * dtype_bytes


def kv_cache_bytes(cfg: ModelConfig, batch: int, length: int) -> float:
    if cfg.family == "xlstm":
        from repro_torch.models.ssm import mlstm_inner
        di = mlstm_inner(cfg)
        dk = di // cfg.num_heads
        n_m = cfg.num_layers - cfg.num_layers // cfg.slstm_every
        return n_m * batch * cfg.num_heads * dk * dk * 4.0
    per_tok = 0.0
    state = 0.0
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * cfg.d_model
        state = cfg.num_layers * batch * (di // cfg.ssm_headdim) * \
            cfg.ssm_headdim * cfg.ssm_state * 4.0
        n_attn = cfg.num_layers // cfg.attn_every
        per_tok = n_attn * 2 * cfg.num_kv_heads * cfg.head_dim * 2.0
    elif cfg.attention_type == "mla":
        per_tok = cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2.0
    else:
        per_tok = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2.0
    if cfg.family == "encdec":  # cached per-layer cross K/V over the frames
        state += (cfg.num_layers * batch * cfg.encoder_frames * 2 *
                  cfg.num_kv_heads * cfg.head_dim * 2.0)
    return state + per_tok * batch * length


# ---------------------------------------------------------------------------
# explicit matmul inventory (shapes, not just FLOP totals)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatmulShape:
    """One (m, k) @ (k, n) matmul instance class in a model's workload.

    ``stationary`` marks matmuls whose (k, n) operand is a fixed parameter
    (projections, MLP, experts, recurrent weights) — the class an IMC
    engine can hold resident; score/value contractions and SSD/mLSTM cell
    products multiply two activations and are tagged ``stationary=False``.
    ``m`` may be fractional (per-expert average of routed tokens).
    """
    name: str
    m: float
    k: int
    n: int
    count: float = 1.0
    stationary: bool = True

    @property
    def macs(self) -> float:
        return self.m * self.k * self.n * self.count

    @property
    def flops(self) -> float:
        return 2.0 * self.macs


class _Inv:
    """Accumulates MatmulShape entries, merging identical classes."""

    def __init__(self):
        self._d: Dict[Tuple, List[float]] = {}

    def add(self, name, m, k, n, count=1.0, stationary=True):
        if m <= 0 or k <= 0 or n <= 0 or count <= 0:
            return
        key = (name, float(m), int(k), int(n), bool(stationary))
        self._d.setdefault(key, [0.0])[0] += count

    def entries(self) -> List[MatmulShape]:
        return [MatmulShape(name=k[0], m=k[1], k=k[2], n=k[3], count=c[0],
                            stationary=k[4])
                for k, c in sorted(self._d.items())]


def _attn_inventory(inv: _Inv, cfg: ModelConfig, t: float, kv_len: float,
                    prefix: str = "attn"):
    """Mirror of _attn_flops_per_tok as explicit shapes (one layer)."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv = max(1, round(kv_len))
    if cfg.attention_type == "mla":
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        inv.add(f"{prefix}.q_down", t, d, cfg.q_lora_rank or d)
        if cfg.q_lora_rank:
            inv.add(f"{prefix}.q_up", t, cfg.q_lora_rank, h * qk)
        inv.add(f"{prefix}.kv_down", t, d,
                cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        inv.add(f"{prefix}.kv_up", t, cfg.kv_lora_rank,
                h * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        inv.add(f"{prefix}.out", t, h * cfg.v_head_dim, d)
        inv.add(f"{prefix}.scores", t, qk, kv, count=h, stationary=False)
        inv.add(f"{prefix}.values", t, kv, cfg.v_head_dim, count=h,
                stationary=False)
        return
    inv.add(f"{prefix}.q", t, d, h * hd)
    inv.add(f"{prefix}.kv", t, d, 2 * kh * hd)
    inv.add(f"{prefix}.out", t, h * hd, d)
    inv.add(f"{prefix}.scores", t, hd, kv, count=h, stationary=False)
    inv.add(f"{prefix}.values", t, kv, hd, count=h, stationary=False)


def _mlp_inventory(inv: _Inv, cfg: ModelConfig, t: float, prefix="mlp"):
    if cfg.mlp_gated:
        inv.add(f"{prefix}.gate", t, cfg.d_model, cfg.d_ff)
    inv.add(f"{prefix}.up", t, cfg.d_model, cfg.d_ff)
    inv.add(f"{prefix}.down", t, cfg.d_ff, cfg.d_model)


def _moe_inventory(inv: _Inv, cfg: ModelConfig, t: float):
    act = cfg.num_experts_per_tok + cfg.num_shared_experts
    inv.add("moe.router", t, cfg.d_model, cfg.num_experts)
    m_e = t * act / cfg.num_experts  # routed tokens per expert matrix
    inv.add("moe.expert_gate", m_e, cfg.d_model, cfg.moe_d_ff,
            count=cfg.num_experts)
    inv.add("moe.expert_up", m_e, cfg.d_model, cfg.moe_d_ff,
            count=cfg.num_experts)
    inv.add("moe.expert_down", m_e, cfg.moe_d_ff, cfg.d_model,
            count=cfg.num_experts)


def _mamba_inventory(inv: _Inv, cfg: ModelConfig, t: float, chunk=256):
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    inv.add("mamba.in_proj", t, cfg.d_model,
            2 * di + 2 * n + di // cfg.ssm_headdim)
    inv.add("mamba.ssd_bc", t, di, n, count=2, stationary=False)
    inv.add("mamba.ssd_intra", t, chunk, di, stationary=False)
    inv.add("mamba.out_proj", t, di, cfg.d_model)


def _mlstm_inventory(inv: _Inv, cfg: ModelConfig, t: float, chunk=256):
    from repro_torch.models.ssm import mlstm_inner
    di = mlstm_inner(cfg)
    dk = di // cfg.num_heads
    inv.add("mlstm.up", t, cfg.d_model, 2 * di)
    inv.add("mlstm.qkv", t, di, 3 * dk)
    inv.add("mlstm.intra", t, chunk, 2 * dk, count=cfg.num_heads,
            stationary=False)
    inv.add("mlstm.state", t, dk, 2 * dk, count=cfg.num_heads,
            stationary=False)
    inv.add("mlstm.down", t, di, cfg.d_model)


def _slstm_inventory(inv: _Inv, cfg: ModelConfig, t: float):
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    inv.add("slstm.gates", t, d, 4 * d)
    inv.add("slstm.recurrent", t, hd, 4 * hd, count=h)
    inv.add("slstm.out", t, d, d)


def matmul_inventory(cfg: ModelConfig, shape: ShapeConfig) -> List[MatmulShape]:
    """Every matmul in one step of this cell, as explicit (m, k, n) shapes.

    Structural mirror of ``fwd_flops_per_token`` + ``_encoder_flops`` +
    ``_cross_attn_flops``: the summed ``.flops`` of the inventory equals the
    closed-form forward FLOP count (pinned by tests/test_sim.py), but keeps
    the shape/count/stationarity structure a hardware mapper needs.
    Train shapes report the forward pass only (the backward runs native
    bf16 on the baseline accelerator, not on the IMC engine).
    """
    b, s = shape.global_batch, shape.seq_len
    prefix = cfg.num_prefix_tokens
    kv = s + prefix
    if shape.kind == "decode":
        t = float(b)
        eff_base = float(kv)
    else:
        t = float(b) * (s + prefix)
        eff_base = (kv + 1) / 2
    inv = _Inv()
    for i in range(cfg.num_layers):
        if cfg.family == "xlstm":
            per = cfg.slstm_every
            if (i % per) == per - 1:
                _slstm_inventory(inv, cfg, t)
            else:
                _mlstm_inventory(inv, cfg, t)
            continue
        if cfg.family == "hybrid":
            _mamba_inventory(inv, cfg, t)
            continue
        eff = _layer_eff_kv(cfg, i, eff_base)
        _attn_inventory(inv, cfg, t, eff)
        if cfg.num_experts and i >= cfg.first_dense_layers:
            _moe_inventory(inv, cfg, t)
        else:
            _mlp_inventory(inv, cfg, t)
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
        for _ in range(n_attn):
            _attn_inventory(inv, cfg, t, eff_base, prefix="shared_attn")
            _mlp_inventory(inv, cfg, t, prefix="shared_mlp")
        inv.add("shared_lora.down", t, cfg.d_model, cfg.lora_rank,
                count=n_attn)
        inv.add("shared_lora.up", t, cfg.lora_rank, cfg.d_model,
                count=n_attn)
    if cfg.family == "encdec":
        t_enc = float(b) * cfg.encoder_frames
        for _ in range(cfg.encoder_layers):
            _attn_inventory(inv, cfg, t_enc, cfg.encoder_frames,
                            prefix="enc_attn")
            _mlp_inventory(inv, cfg, t_enc, prefix="enc_mlp")
        d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.head_dim, \
            cfg.encoder_frames
        t_x = t if shape.kind != "decode" else float(b)
        inv.add("cross_attn.q", t_x, d, h * hd, count=cfg.num_layers)
        inv.add("cross_attn.out", t_x, h * hd, d, count=cfg.num_layers)
        inv.add("cross_attn.scores", t_x, hd, f, count=cfg.num_layers * h,
                stationary=False)
        inv.add("cross_attn.values", t_x, f, hd, count=cfg.num_layers * h,
                stationary=False)
    inv.add("logits", t, cfg.d_model, cfg.vocab_size)
    return inv.entries()


# ---------------------------------------------------------------------------
# OISMA-engine backend: the same inventory, projected onto the paper's
# in-memory-computing engine (repro_torch.sim) instead of the H100 roofline
# ---------------------------------------------------------------------------

def oisma_engine_projection(cfg: ModelConfig, shape: ShapeConfig, *,
                            engines: int = 1, technology_nm: int = 22,
                            double_buffered: bool = True,
                            include_attention: bool = False,
                            ) -> Dict[str, float]:
    """Engine-projected step terms for one cell, stamped by the dry-run
    next to the card roofline (``roofline.oisma_engine`` in the records).

    Maps ``matmul_inventory(cfg, shape)`` onto the OISMA engine via
    ``repro_torch.sim`` — weight matmuls only by default, matching the paper's
    weight-stationary deployment.  ``latency_s`` is the engine step time
    with double-buffered reprogramming (serial-stall time reported next to
    it, so the stamp shows what the overlap buys); ``engines > 1`` prices
    a ``repro_torch.sim.scaleout`` cluster instead and adds the scaling
    efficiency.  Closed-form arithmetic only — cheap enough to stamp on
    every dry-run cell.
    """
    from repro_torch.sim import ClusterConfig, EngineConfig, map_model
    from repro_torch.sim.scaleout import map_model_cluster
    eng = EngineConfig(technology_nm=technology_nm,
                       double_buffered=double_buffered)
    serial = EngineConfig(technology_nm=technology_nm)
    w = map_model(cfg, shape, eng, include_attention=include_attention)
    ws = map_model(cfg, shape, serial, include_attention=include_attention)
    out = {
        "backend": "oisma_engine",
        "engines": engines,
        "technology_nm": technology_nm,
        "double_buffered": double_buffered,
        "latency_s": w.latency_s,
        "serial_reprogram_latency_s": ws.latency_s,
        "utilization": w.utilization,
        "achieved_tops_per_watt": w.achieved_tops_per_watt,
        "gops_per_mm2": w.gops_per_mm2,
    }
    if engines > 1:
        rep = map_model_cluster(
            cfg, shape, ClusterConfig(engines=engines, engine=eng),
            include_attention=include_attention)
        out.update({
            "latency_s": rep.latency_s,
            "utilization": rep.utilization,
            "achieved_tops_per_watt": rep.achieved_tops_per_watt,
            "gops_per_mm2": rep.gops_per_mm2,
            "scaling_efficiency": rep.scaling_efficiency,
        })
    return out


#: Activation-traffic coefficient: bytes moved per token per layer per
#: d_model unit.  ~10 tensor read/writes fwd (norms, qkv, scores path, mlp
#: in/out) in bf16; bwd ~2x; remat adds ~1x fwd.
ACT_RW_FWD = 10 * 2
ACT_RW_TRAIN = ACT_RW_FWD * 4


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                   accum: int = 1, moment_bytes: int = 4) -> Dict[str, float]:
    """Whole-fleet HBM traffic per step (sum over chips)."""
    b, s = shape.global_batch, shape.seq_len
    p = param_bytes(cfg)  # bf16
    if shape.kind == "train":
        tokens = b * s
        # each microbatch reads weights fwd + bwd (regather under FSDP)
        weights = p * 2 * accum
        # optimizer: read p, m, v, grad; write p, m, v (grad fp32)
        n_params = p / 2
        opt = n_params * (2 + 2 * moment_bytes + 4 + 2 + 2 * moment_bytes)
        acts = tokens * cfg.d_model * ACT_RW_TRAIN * cfg.num_layers
        total = weights + opt + acts
        return {"total": total, "weights": weights, "opt": opt, "acts": acts}
    if shape.kind == "prefill":
        tokens = b * s
        weights = p
        acts = tokens * cfg.d_model * ACT_RW_FWD * cfg.num_layers
        cache = kv_cache_bytes(cfg, b, s)  # written once
        return {"total": weights + acts + cache, "weights": weights,
                "acts": acts, "cache": cache}
    # decode: read all (sharded) weights + the whole cache, once per token
    weights = p
    cache = kv_cache_bytes(cfg, b, s)
    if cfg.window_size:  # SWA layers only read the window
        if cfg.local_global_pattern:
            per = cfg.local_global_pattern + 1
            frac_global = 1.0 / per
        else:
            frac_global = 0.0
        eff = frac_global + (1 - frac_global) * min(1.0, cfg.window_size / s)
        cache = cache * eff
    acts = b * cfg.d_model * ACT_RW_FWD * cfg.num_layers
    return {"total": weights + cache + acts, "weights": weights,
            "cache": cache, "acts": acts}


# ---------------------------------------------------------------------------
# collective traffic (per chip)
# ---------------------------------------------------------------------------

def cell_collective_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          mesh: MeshSpec, accum: int = 1,
                          act_bytes: int = 2, grad_bytes: int = 4,
                          tp_ar_per_layer: int = 4) -> Dict[str, float]:
    """Per-chip link bytes per step under the implemented sharding:

    train:  FSDP all-gather of bf16 params per microbatch (fwd+bwd)
            + grad all-reduce over (pod x data)
            + TP all-reduces on activations (bf16 in the lowered program:
              activations stay bf16 through ``dense``), 2 fwd + 2 bwd per
              layer by default
    prefill/decode: TP all-reduces on activations (+ softmax partials for
            the sequence-sharded cache).

    The knobs (act_bytes, grad_bytes, tp_ar_per_layer) parameterise the
    §Perf hillclimb iterations.

    Pipelined cells (``mesh.stage`` > 1) describe the composed
    (stage, data, model) layout the stage-aware train step actually
    compiles: weights shard over model x stage (``weight_shards``), a chip
    participates in the TP/EP collectives of its own stage's L/stage
    layers only, and the microbatch hand-offs add a collective-permute
    term.
    """
    b, s = shape.global_batch, shape.seq_len
    p = param_bytes(cfg)
    d = mesh.dp
    t = mesh.model
    out: Dict[str, float] = {}
    if shape.kind == "train":
        # FSDP: params live sharded over data (on top of the TP/stage
        # weight sharding); each flush all-gathers the per-chip block; ring
        # all-gather moves (d-1)/d of the gathered bytes per chip; twice
        # (fwd + bwd regather).
        ws = mesh.weight_shards
        if d > 1:
            out["fsdp_allgather"] = 2 * accum * (p / ws) * (d - 1) / d
            out["grad_reduce"] = 2 * (grad_bytes * p / 2 / ws) * (d - 1) / d
        layers_local = cfg.num_layers / mesh.stage
        if t > 1:
            tok_local = b * s / d
            act = tok_local * cfg.d_model * act_bytes
            out["tp_allreduce"] = (layers_local * tp_ar_per_layer * act *
                                   2 * (t - 1) / t)
        if cfg.num_experts and t > 1:
            # EP all-to-all: each routed token crosses shards at dispatch
            # and combine, fwd + bwd -> 4x, (t-1)/t stays off-chip
            tok_local = b * s / d
            moe_layers = (cfg.num_layers - cfg.first_dense_layers) \
                / mesh.stage
            routed = tok_local * cfg.num_experts_per_tok * cfg.d_model * \
                act_bytes
            out["ep_all_to_all"] = moe_layers * 4 * routed * (t - 1) / t
        if mesh.stage > 1:
            # GPipe hand-offs: each microbatch's activation crosses every
            # stage boundary once fwd + once bwd (collective-permute:
            # result bytes == wire bytes per chip)
            tok_local = b * s / d
            out["pp_permute"] = 2 * tok_local * cfg.d_model * act_bytes
        return {**out, "total": sum(out.values())}
    tok_local = (b * s if shape.kind == "prefill" else b) / max(1, d)
    if shape.kind == "decode" and b < d:
        tok_local = float(b)  # batch not shardable; replicated work
    if t > 1:
        act = tok_local * cfg.d_model * act_bytes
        out["tp_allreduce"] = cfg.num_layers * 2 * act * 2 * (t - 1) / t
    if cfg.num_experts and t > 1:  # EP all-to-all, fwd only (2x: disp+comb)
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        routed = tok_local * cfg.num_experts_per_tok * cfg.d_model * act_bytes
        out["ep_all_to_all"] = moe_layers * 2 * routed * (t - 1) / t
    if shape.kind == "decode":
        # sequence-sharded cache: softmax partials all-reduce (fp32, tiny) +
        # gathering the output latent: ~ b*d_model per layer
        out["seq_softmax"] = cfg.num_layers * b * cfg.d_model * 4 * 2 * (t - 1) / t
    if shape.kind == "decode" and mesh.seq > 1:
        # ring attention over the "seq" axis (stats schedule, the decode
        # default in repro_torch.dist.seq): the per-block online-softmax partial
        # tuple — m, l scalars plus the fp32 accumulator row per head —
        # travels seq-1 ppermute hops per attention layer.  Like pp_permute
        # this is a collective-permute: result bytes == wire bytes per
        # chip.  GQA accumulates per-head values (head_dim); absorbed MLA
        # accumulates in the latent (kv_lora_rank).
        n_ring = mesh.seq
        per_head = (cfg.kv_lora_rank if cfg.attention_type == "mla"
                    else cfg.head_dim) + 2
        if cfg.family == "xlstm":
            n_attn = 0
        elif cfg.family == "hybrid":
            n_attn = cfg.num_layers // cfg.attn_every
        else:
            n_attn = cfg.num_layers
        out["ring_permute"] = ((n_ring - 1) * n_attn * b * cfg.num_heads *
                               per_head * 4)
    return {**out, "total": sum(out.values())}


# ---------------------------------------------------------------------------
# assembled terms
# ---------------------------------------------------------------------------

def analytic_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                  accum: int = 1, remat: bool = True,
                  moment_bytes: int = 4,
                  pipeline_bubble: float = 0.0) -> Dict[str, float]:
    from repro_torch.roofline.analysis import RooflineTerms, model_flops_estimate
    fl = cell_flops(cfg, shape, remat=remat)
    mem = cell_hbm_bytes(cfg, shape, mesh, accum=accum,
                         moment_bytes=moment_bytes)
    coll = cell_collective_bytes(cfg, shape, mesh, accum=accum)
    terms = RooflineTerms(
        flops=fl["total"], hbm_bytes=mem["total"],
        coll_bytes_per_chip=coll["total"], chips=mesh.chips,
        model_flops=model_flops_estimate(cfg, shape),
        pipeline_bubble=pipeline_bubble)
    return {"terms": terms, "flops": fl, "hbm": mem, "coll": coll}


# ---------------------------------------------------------------------------
# per-device memory budget (the "fits in HBM" argument)
# ---------------------------------------------------------------------------

def memory_budget_per_device(cfg: ModelConfig, shape: ShapeConfig,
                             mesh: MeshSpec, accum: int = 1,
                             moment_bytes: int = 4,
                             dp_only: bool = False) -> Dict[str, float]:
    """Bytes per device: params + optimizer + grads + live activations/cache.

    Default rules shard params 2D (d_model over data x ffn/heads over
    model); dp_only shards over data only (replicated across model).
    Activations under full remat + layer scan: saved layer inputs
    (L x micro_tokens_local x d x 2B) + one live layer's working set
    (~6 tensors of micro_tokens_local x max(d, d_ff_shard) x 2B).
    """
    p_shards = mesh.data if dp_only else mesh.data * mesh.model
    n_params = param_bytes(cfg) / 2.0
    out: Dict[str, float] = {}
    out["params_bf16"] = 2.0 * n_params / p_shards
    if shape.kind == "train":
        out["opt_moments"] = 2.0 * moment_bytes * n_params / p_shards
        out["grads_fp32"] = 4.0 * n_params / p_shards
        dp = mesh.dp * (mesh.model if dp_only else 1)
        micro_tok = shape.global_batch * shape.seq_len / accum / dp
        d = cfg.d_model
        out["saved_layer_inputs"] = cfg.num_layers * micro_tok * d * 2.0
        ff_shard = max(d, (cfg.d_ff or d) / (1 if dp_only else mesh.model))
        out["live_layer_workspace"] = 6.0 * micro_tok * ff_shard * 2.0
        if cfg.family == "hybrid":
            di = cfg.ssm_expand * d
            q = cfg.ssm_chunk
            dtype_b = 2.0 if cfg.ssm_decay_bf16 else 4.0
            bloc = shape.global_batch / accum / dp
            nheads = di // cfg.ssm_headdim
            out["ssd_decay_live"] = bloc * nheads * shape.seq_len * q * dtype_b
    else:
        dp = mesh.dp
        cache = kv_cache_bytes(cfg, shape.global_batch, shape.seq_len)
        # the cache token dim additionally shards over any "sequence" axes
        # (ring attention); with a small batch every axis ends up sharding
        # the cache one way or another (folded layout)
        cache_shards = (mesh.chips if shape.global_batch < dp
                        else dp * mesh.model * mesh.seq)
        out["kv_cache"] = cache / cache_shards
        tok_local = (shape.global_batch * shape.seq_len / dp
                     if shape.kind == "prefill" else shape.global_batch)
        out["live_activations"] = 8.0 * tok_local * cfg.d_model * 2.0
    out["total"] = sum(out.values())
    return out
