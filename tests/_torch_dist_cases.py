"""The distributed layer's cases, run in ranks of their own on the CPU.

``tests/test_torch_dist*.py`` write each world's inputs to a pickle and
run ``python -c "import _torch_dist_cases as c; c.main(...)"`` in a
subprocess with its own timeout; ``main`` starts the ranks
(``launch_ranks``, gloo, one torch thread a rank) and pickles rank 0's
results for the test to compare.  Every rank builds each mesh (a Mesh
spans every rank) and runs every case in the same order.  Nothing here
imports jax.
"""
import contextlib
import dataclasses
import pickle
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import pipeline as pp
from repro_torch.dist import sharding as shd
from repro_torch.dist import tp as mtp
from repro_torch.launch.mesh import Mesh, launch_ranks
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import TrainerConfig, train


def cfg_of(arch, mode, **kw):
    return dataclasses.replace(get_config(arch, smoke=True),
                               matmul_mode=mode, **kw)


def whole_grads(model, mesh, grads):
    """Every rank's gradient pieces gathered to whole numpy leaves."""
    pl = ts.param_placements(model, mesh)
    shapes = tree_map(lambda d: d.shape, model.schema())
    whole = tree_map(lambda g, p, s: shd.gather(g, p, mesh, s), grads, pl,
                     shapes)
    return {"/".join(k): v.numpy() for k, v in tree_leaves(whole)}


def local_params(tree, cfg, model, mesh, f32=False):
    """This rank's pieces of a whole numpy param tree."""
    whole = params_from_numpy(tree, cfg, "cpu")
    if f32:
        whole = tree_map(lambda t: t.float(), whole)
    return tree_map(lambda t, p: shd.local_shard(t, p, mesh).clone(), whole,
                    ts.param_placements(model, mesh))


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def loss_case(mesh, c):
    """pipeline_loss of one case: {"loss", "aux", "grads"}."""
    cfg = cfg_of(c["arch"], c["mode"], **c.get("cfg", {}))
    model = build(cfg)
    if "params" in c:
        params = local_params(c["params"], cfg, model, mesh, c.get("f32"))
    else:
        params = ts.init_state(model, c.get("seed", 0), OptimizerConfig(),
                               "cpu", mesh=mesh)["params"]
        if c.get("f32"):
            params = tree_map(lambda t: t.float(), params)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics, grads = model.pipeline_loss(
        live, torch_batch(c["batch"]), mesh=mesh,
        num_microbatches=c.get("M", 1), schedule=c.get("schedule", "1f1b"),
        batch_axes=c.get("batch_axes", ("data",)))
    return {"loss": float(loss), "aux": float(metrics["aux_loss"]),
            "grads": whole_grads(model, mesh, grads)}


def per_shard_case(mesh, c):
    """The control of the global scale rule: the unpipelined loss and its
    autograd gradients on this rank's pieces of a stage-free mesh (no
    data axis), under the plan with each rank's scales taken on its own
    pieces (``use_stage_tp(exact=False)``, no ``global_scales``)."""
    cfg = cfg_of(c["arch"], c["mode"])
    model = build(cfg)
    params = ts.init_state(model, c.get("seed", 0), OptimizerConfig(),
                           "cpu", mesh=mesh)["params"]
    live = tree_map(lambda p: p.detach().float().requires_grad_(), params)
    flat = [t for _, t in tree_leaves(live)]
    with mtp.use_stage_tp(mtp.plan_stage_tp(cfg, mesh), mesh, exact=False):
        loss, _ = model.loss(live, torch_batch(c["batch"]))
        got = torch.autograd.grad(loss, flat)
    grads = tree_unflatten(live, [g.float() for g in got])
    return {"loss": float(loss), "grads": whole_grads(model, mesh, grads)}


# ---------------------------------------------------------------------------
# the toy pipeline of the reference's tests: residual tanh layers
# ---------------------------------------------------------------------------

def toy_layer(w, x):
    return x + torch.tanh(x @ w)


def toy_case(mesh, c):
    """``pipeline_apply``'s forward, and ``pipeline_grads``' y, dW and dX
    under both schedules for the output cotangent GY."""
    W, X, GY = (torch.from_numpy(c[k]) for k in ("W", "X", "GY"))
    S, s = mesh.size("stage"), mesh.index("stage")
    lo, hi = pp.stage_layers(W.shape[0], S, s)
    out = {"apply": pp.pipeline_apply(
        lambda a: _toy_stage(W[lo:hi], a), X, mesh).numpy()}
    M = X.shape[0]
    for sched in ("1f1b", "gpipe"):
        w = W[lo:hi].clone().requires_grad_()
        ys, dxs = {}, {}

        def stage_fn(a, m, w=w):
            return _toy_stage(w, a), None

        def last_fn(y, m, ys=ys):
            ys[m] = y.detach()
            return (y * GY[m]).sum()

        got, _, _, _ = pp.pipeline_grads(
            stage_fn, mesh, M, inputs=[w], act_shape=X.shape[1:],
            act_dtype=X.dtype,
            first_fn=lambda m: X[m].clone().requires_grad_(),
            last_fn=last_fn, on_input_grad=lambda m, g, dxs=dxs:
            dxs.__setitem__(m, g), schedule=sched)
        dw = shd.gather(got[0], ("stage", None, None), mesh, W.shape)
        y = torch.stack([ys[m] for m in range(M)]) if ys else \
            torch.zeros_like(X)
        dx = torch.stack([dxs[m] for m in range(M)]) if dxs else \
            torch.zeros_like(X)
        mesh.all_reduce(y, "stage")
        mesh.all_reduce(dx, "stage")
        out[sched] = {"y": y.numpy(), "dW": dw.numpy(), "dX": dx.numpy()}
    return out


def _toy_stage(w, a):
    for i in range(w.shape[0]):
        a = toy_layer(w[i], a)
    return a


# ---------------------------------------------------------------------------
# one layer under a TP plan (the reference's sharded layer's counterpart)
# ---------------------------------------------------------------------------

def _cut_tree(tree, placements, mesh):
    return tree_map(lambda t, p: shd.local_shard(
        torch.from_numpy(np.asarray(t)), p, mesh).clone(), tree, placements)


def layer_case(mesh, c):
    """``mlp_apply``/``gqa_apply``/``moe_apply``/``mla_apply`` on this
    rank's pieces of whole numpy weights, under the plan."""
    cfg = cfg_of(c["arch"], c["mode"])
    plan = mtp.plan_stage_tp(cfg, mesh)
    x = torch.from_numpy(c["x"]).to(torch.bfloat16)
    # the layer's leaves' placements, without the stack's leading entry
    pl = mtp.layer_placements(plan, {c["layer"]: c["axes"]}, None)
    pl = tree_map(lambda e: e[1:], pl[c["layer"]])
    p = _cut_tree(c["params"], pl, mesh)
    p = tree_map(lambda t, d: t.to(d), p, c["dtypes"])
    b, s, _ = x.shape
    pos = torch.arange(s)[None].expand(b, s)
    with mtp.use_stage_tp(plan, mesh):
        if c["layer"] == "mlp":
            y = L.mlp_apply(p, x, cfg.act, True, cfg.matmul_mode)
        elif c["layer"] == "gqa":
            y = A.gqa_apply(p, cfg, x, pos, window=cfg.window_size)[0]
        elif c["layer"] == "mla":
            y = A.mla_apply(p, cfg, x, pos)[0]
        else:
            y = MOE.moe_apply(p, cfg, x)["out"]
    return y.float().numpy()


# ---------------------------------------------------------------------------
# the trainer and checkpoints on a mesh
# ---------------------------------------------------------------------------

def trainer_case(mesh, c):
    """``train(mesh=)`` for ``c["steps"]``, checkpointing into
    ``c["ckpt"]``; the history, and the gathered final state."""
    cfg = cfg_of(c["arch"], c["mode"])
    model = build(cfg)
    tcfg = TrainerConfig(total_steps=c["steps"], ckpt_every=c["steps"],
                         ckpt_dir=c.get("ckpt"), ckpt_async=False,
                         ckpt_compress_opt=False, seed=c.get("seed", 0))
    opt = OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                          total_steps=c["steps"])
    state, hist = train(model, cfg, ShapeConfig("t", "train",
                                                c["seq"], c["batch"]),
                        tcfg, opt_cfg=opt, mesh=mesh, device=mesh.device)
    return {"losses": [h["loss"] for h in hist],
            "state": _whole_state(state, model, mesh)}


def restore_case(mesh, c):
    """Cut a checkpoint onto this mesh (``train`` resumes from it at its
    last step, so it runs no step) and gather it back."""
    cfg = cfg_of(c["arch"], c["mode"])
    model = build(cfg)
    tcfg = TrainerConfig(total_steps=c["steps"], ckpt_dir=c["ckpt"],
                         ckpt_async=False, ckpt_compress_opt=False)
    state, hist = train(model, cfg, ShapeConfig("t", "train", c["seq"],
                                                c["batch"]), tcfg,
                        mesh=mesh, device=mesh.device)
    return {"steps_run": len(hist),
            "state": _whole_state(state, model, mesh)}


def _whole_state(state, model, mesh):
    """The state gathered to the mesh's first rank, as numpy (None on the
    other ranks)."""
    whole = ts.gather_state(state, model, mesh, keep=mesh.position == 0)
    if whole is None:
        return None
    return {"/".join(k): v.float().numpy() for k, v in tree_leaves(whole)}


# ---------------------------------------------------------------------------
# sequence parallelism: the ring core and the decoder under a ring
# ---------------------------------------------------------------------------

def _every_rank(mesh, t):
    """``t`` of every rank of ``mesh`` (equal shapes), as numpy, in the
    mesh's row-major order."""
    return [p.numpy() for p in mesh.all_gather(t.contiguous(),
                                               mesh.axis_names)]


def _ring_core_one(mesh, c):
    """One ring-core case on this rank: its output piece and the port's
    oracle's same piece (computed here, on this rank's heads)."""
    from repro_torch.dist import seq
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in c["args"].items()}
    n, si = mesh.size("seq"), mesh.index("seq")
    tp, mi = mesh.size("model"), mesh.index("model")
    if c["op"] == "mla":
        qa, qr, ckv, kr, qp, kp = (t[k] for k in ("qa", "qr", "ckv", "kr",
                                                  "q_pos", "kv_pos"))
        c_blk = ckv.shape[1] // n
        cut = slice(si * c_blk, (si + 1) * c_blk)
        got = seq.ring_attend_mla(qa, qr, ckv[:, cut], kr[:, cut], qp,
                                  kp[:, cut], scale=c["scale"])
        want = A.ring_mla_reference(qa, qr, ckv, kr, qp, kp, n_blocks=n,
                                    scale=c["scale"])
        return got, want
    q, k, v, qp, kp = (t[k] for k in ("q", "k", "v", "q_pos", "kv_pos"))
    # this rank's heads: a block of q heads over its block of kv heads
    hq, hk = q.shape[2] // tp, k.shape[2] // tp
    q = q[:, :, mi * hq:(mi + 1) * hq]
    k, v = k[:, :, mi * hk:(mi + 1) * hk], v[:, :, mi * hk:(mi + 1) * hk]
    kw = {key: t[key] for key in ("causal", "window", "prefix_len",
                                  "softcap") if key in t}
    if c["op"] == "schedules":      # both schedules on whole queries
        c_blk = k.shape[1] // n
        cut = slice(si * c_blk, (si + 1) * c_blk)
        outs = [A.ring_sdpa(q, k[:, cut], v[:, cut], qp, kp[:, cut],
                            mesh=mesh, axes=("seq",), n_blocks=n,
                            rotate=rot, **kw) for rot in ("kv", "stats")]
        return outs[0], outs[1]
    if c["op"] == "kv":             # sharded rows rotate the KV blocks
        sq = q.shape[1]
        lay = seq.row_ring(q.shape[0], sq)
        lo, r = lay.block(sq)
        klo, kc = lay.block(k.shape[1])
        with seq.shard_rows(sq, lay):
            got = seq.ring_attend(q[:, lo:lo + r], k[:, klo:klo + kc],
                                  v[:, klo:klo + kc], qp[:, lo:lo + r],
                                  kp[:, klo:klo + kc], kv_local=True, **kw)
        want = A.ring_reference(q, k, v, qp, kp, n_blocks=n, q_blocks=n,
                                **kw)[:, lo:lo + r]
        return got, want
    # "stats": whole queries, the whole KV padded and cut inside
    got = seq.ring_attend(q, k, v, qp, kp, **kw)
    kp_, vp_, pp_ = seq.pad_kv(k, v, kp, -(-k.shape[1] // n) * n)
    want = A.ring_reference(q, kp_, vp_, qp, pp_, n_blocks=n, **kw)
    return got, want


def ring_core_case(mesh, c):
    """The ring-core cases on this mesh under the "sequence" rules: every
    rank's output piece, and whether each equals the port's oracle's
    piece bit for bit."""
    from repro_torch.dist import seq
    out = {}
    with shd.use_rules(mesh, shd.get_rules("sequence")), seq.use_ring(mesh):
        for name, one in c["cases"]:
            mesh.reset_stats()
            got, want = _ring_core_one(mesh, one)
            sends = sum(s.calls for (op, _), s in mesh.stats.items()
                        if op == "send")
            same = torch.tensor([float(torch.equal(got, want)), sends])
            out[name] = {"pieces": _every_rank(mesh, got),
                         "bitwise": [bool(x[0]) for x in
                                     _every_rank(mesh, same)],
                         "sends": [int(x[1]) for x in
                                   _every_rank(mesh, same)]}
    return out


def ring_model_case(mesh, c):
    """A decoder's prefill into a cache of ``c["cache_len"]`` and decode
    steps of the given tokens under the ring, on this rank; the same
    calls without a ring on this rank as the control.  Returns every
    call's logits, every rank's cache block after prefill and at the end,
    the ops sent in prefill and in decode, the fused decode attention's
    calls and the rows each MoE layer routed."""
    from repro_torch.dist import seq
    from repro_torch.kernels import attention as KA
    cfg = cfg_of(c["arch"], c["mode"], kv_quant=c["kv_quant"])
    model = build(cfg)
    params = params_from_numpy(c["params"], cfg, "cpu")
    toks = torch.from_numpy(c["tokens"])
    calls = {"row4": 0, "moe_rows": []}
    row4, moe_apply = KA.bp8_decode_attention, MOE.moe_apply

    def counted_row4(*a, **kw):
        calls["row4"] += 1
        return row4(*a, **kw)

    def counted_moe(p, cfg_, x, **kw):
        calls["moe_rows"].append(x.shape[1])
        return moe_apply(p, cfg_, x, **kw)

    def run(ring):
        ctx = (shd.use_rules(mesh, shd.get_rules("sequence")), seq.use_ring(
            mesh)) if ring else ()
        logits, caches, stats = [], [], []
        with contextlib.ExitStack() as stack:
            for cm in ctx:
                stack.enter_context(cm)
            mesh.reset_stats()
            lg, cache = model.prefill(params, {"tokens": toks},
                                      c["cache_len"])
            stats.append({op: s.calls for (op, _), s in mesh.stats.items()})
            logits.append(lg)
            caches.append({k: v.clone() for k, v in
                           cache["layers"].items()})
            mesh.reset_stats()
            for i, tok in enumerate(c["decode"]):
                lg, cache = model.decode_step(
                    params, torch.from_numpy(tok)[:, None], cache,
                    toks.shape[1] + i)
                logits.append(lg)
            stats.append({op: s.calls for (op, _), s in mesh.stats.items()})
            caches.append(cache["layers"])
        return logits, caches, stats

    KA.bp8_decode_attention, MOE.moe_apply = counted_row4, counted_moe
    try:
        logits, caches, stats = run(True)
        ring_calls = {"row4": calls["row4"],
                      "moe_rows": list(calls["moe_rows"])}
        calls.update(row4=0, moe_rows=[])
        single, _, _ = run(False)
    finally:
        KA.bp8_decode_attention, MOE.moe_apply = row4, moe_apply
    return {
        "logits": [lg.float().numpy() for lg in logits],
        "single": [lg.float().numpy() for lg in single],
        "ranks_agree": all(
            all(np.array_equal(p, ps[0]) for p in ps)
            for ps in (_every_rank(mesh, lg.float()) for lg in logits)),
        "caches": [{k: [p.astype(np.float32) if p.dtype != np.int32 else p
                        for p in _every_rank(mesh, v.float() if
                                             v.is_floating_point() else v)]
                    for k, v in cache.items()} for cache in caches],
        "stats": stats, "calls": ring_calls, "single_calls": dict(calls)}


def ring_refusals_case(mesh, c):
    """What a ring on this mesh refuses: every family's entry points."""
    from repro_torch.dist import seq
    out = {}
    with shd.use_rules(mesh, shd.get_rules("sequence")), seq.use_ring(mesh):
        for arch in c["archs"]:
            cfg = cfg_of(arch, "bf16")
            model = build(cfg)
            try:
                model.init_cache(1, 8, "cpu")
                out[arch] = None
            except NotImplementedError as e:
                out[arch] = str(e)
        if mesh.size("model") == 1:
            cfg = cfg_of("qwen2_72b", "bf16")
            model = build(cfg)
            try:
                model.prefill_chunk({}, {"tokens": torch.ones(
                    (1, 4), dtype=torch.long)}, None, 0)
                out["prefill_chunk"] = None
            except NotImplementedError as e:
                out["prefill_chunk"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving: the decoders on a ("data", "model") mesh
# ---------------------------------------------------------------------------

def _numel(tree):
    return {"/".join(k): v.numel() for k, v in tree_leaves(tree)}


def tp_serve_case(mesh, c):
    """A decoder's serving calls under ``dist.serving`` on this rank:
    prefill, a chunked prefill of ``c["chunks"]`` into a fresh cache (no
    prefix), then decode steps of the given tokens from the prefill's
    cache, the prefill under ``c["phases"][0]``'s rules and the decode
    under ``[1]``'s.  Returns every call's logits, every rank's cache
    pieces after each run, each rank's cache spec, plan, rows, kv heads
    and elements a leaf, whether the ranks' logits agree, and with
    ``c["single"]`` the same calls' logits and caches in this one process
    without a mesh."""
    from repro_torch.dist import serving as sv
    cfg = cfg_of(c["arch"], c["mode"], kv_quant=c["kv_quant"],
                 **c.get("cfg", {}))
    model = build(cfg)
    whole = params_from_numpy(c["params"], cfg, "cpu")
    if c["w"] == "f32":
        whole = tree_map(lambda t: t.float(), whole)
    toks = torch.from_numpy(c["tokens"])
    b, s = toks.shape
    batch = {"tokens": toks}
    if "patches" in c:
        batch["patches"] = torch.from_numpy(c["patches"]).to(torch.bfloat16)
    length = c["cache_len"] + cfg.num_prefix_tokens
    pre, dec = c["phases"]
    out = {"logits": [], "caches": [], "ranks": {}}

    def rank_info(phase, params):
        with sv.use_tp_serving(mesh, phase, batch=b) as ctx:
            plan = ctx.plan(cfg)
            spec = model.cache_spec(b, length)
            rows = ctx.rows(b)
            heads = ctx.kv_heads(cfg)
        return {"plan": None if plan is None else dataclasses.asdict(plan),
                "spec": {n: {k: tuple(v[0]) for k, v in leaves.items()}
                         for n, leaves in spec.items()},
                "rows": rows, "kv_heads": heads,
                "param_elems": _numel(params)}

    def pieces(cache):
        return {n: {k: _every_rank(mesh, v.float() if v.is_floating_point()
                                   else v) for k, v in leaves.items()}
                for n, leaves in cache.items()}

    r_pre = sv.serving_rules(mesh, pre, b)
    r_dec = sv.serving_rules(mesh, dec, b)
    p_pre = sv.serve_params(model, whole, mesh, r_pre)
    p_dec = sv.serve_params(model, whole, mesh, r_dec)
    with sv.use_tp_serving(mesh, pre, batch=b):
        lg, cache = model.prefill(p_pre, batch, c["cache_len"])
        out["logits"].append(lg)
        out["caches"].append(pieces(cache))
        if c.get("chunks"):
            cc = model.init_cache(b, length, "cpu")
            lo = 0
            for n in c["chunks"]:
                lgc, cc = model.prefill_chunk(
                    p_pre, {"tokens": toks[:, lo:lo + n]}, cc, lo)
                lo += n
                out["logits"].append(lgc)
            out["caches"].append(pieces(cc))
    out["ranks"]["prefill"] = rank_info(pre, p_pre)
    with sv.use_tp_serving(mesh, dec, batch=b):
        for i, tok in enumerate(c["decode"]):
            lg, cache = model.decode_step(
                p_dec, torch.from_numpy(tok)[:, None], cache,
                s + cfg.num_prefix_tokens + i)
            out["logits"].append(lg)
        out["caches"].append(pieces(cache))
    out["ranks"]["decode"] = rank_info(dec, p_dec)
    if c.get("single"):     # the same calls in this one process
        out["single"] = _single_serve(model, whole, batch, c)
    out["ranks_agree"] = all(
        all(np.array_equal(p, ps[0]) for p in ps)
        for ps in (_every_rank(mesh, lg.float()) for lg in out["logits"]))
    out["logits"] = [lg.float().numpy() for lg in out["logits"]]
    every = [None] * mesh.size(mesh.axis_names)
    torch.distributed.all_gather_object(every, out["ranks"],
                                        group=mesh.group(mesh.axis_names))
    out["ranks"] = every
    return out


def _single_serve(model, params, batch, c):
    """``tp_serve_case``'s calls without a mesh: every call's logits and
    the cache after each run, whole."""
    toks = batch["tokens"]
    b, s = toks.shape
    cfg = model.cfg
    logits, caches = [], []

    def whole(cache):
        return {n: {k: (v.float() if v.is_floating_point() else v).numpy()
                    .copy() for k, v in leaves.items()}
                for n, leaves in cache.items()}

    lg, cache = model.prefill(params, batch, c["cache_len"])
    logits.append(lg)
    caches.append(whole(cache))
    if c.get("chunks"):
        cc = model.init_cache(b, c["cache_len"] + cfg.num_prefix_tokens,
                              "cpu")
        lo = 0
        for n in c["chunks"]:
            lgc, cc = model.prefill_chunk(
                params, {"tokens": toks[:, lo:lo + n]}, cc, lo)
            lo += n
            logits.append(lgc)
        caches.append(whole(cc))
    for i, tok in enumerate(c["decode"]):
        lg, cache = model.decode_step(params, torch.from_numpy(tok)[:, None],
                                      cache, s + cfg.num_prefix_tokens + i)
        logits.append(lg)
    caches.append(whole(cache))
    return {"logits": [lg.float().numpy() for lg in logits],
            "caches": caches}


def tp_refusals_case(mesh, c):
    """What a serving mesh refuses: each (arch, mode, batch, call) of
    ``c["calls"]`` under ``use_tp_serving(mesh, "prefill", batch=)``
    gives the error's type and message, or None."""
    from repro_torch.dist import serving as sv
    out = {}
    for name, arch, mode, b, what in c["calls"]:
        cfg = cfg_of(arch, mode)
        model = build(cfg)
        try:
            with sv.use_tp_serving(mesh, "prefill", batch=b):
                if what == "init_cache":
                    model.init_cache(b, 8, "cpu")
                else:
                    model.prefill({}, {"tokens": torch.ones(
                        (b, 4), dtype=torch.long)}, 8)
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def tp_layout_case(mesh, c):
    """What a serving call refuses in the params and the cache it is
    given, at batch 1 on a mesh with "data" (the "decode" rules fold it
    into "model"), for each (arch, kv_quant, config overrides) of
    ``c["archs"]``: the prefill's pieces or the whole params where the
    plan wants others, a cache made without a mesh, and the handover of
    the "prefill" rules' cache to the fold.  Returns {arch/what: None or
    (error type, message)}, and where the handover is taken, its decode
    logits beside those of the request served under the fold alone."""
    from repro_torch.dist import serving as sv
    from repro_torch.models.params import init_params
    out = {}
    for arch, kvq, over in c["archs"]:
        cfg = cfg_of(arch, "bp8_fused", kv_quant=kvq, **over)
        model = build(cfg)
        whole = init_params(model.schema(), 7, "cpu")
        toks = torch.randint(3, cfg.vocab_size, (1, 9),
                             generator=torch.Generator().manual_seed(7))
        tok, length = toks[:, -1:], 16
        pieces = {ph: sv.serve_params(model, whole, mesh,
                                      sv.serving_rules(mesh, ph, 1))
                  for ph in ("prefill", "decode")}
        with sv.use_tp_serving(mesh, "prefill", batch=1):
            _, cache = model.prefill(pieces["prefill"], {"tokens": toks},
                                     length)
        with sv.use_tp_serving(mesh, "decode", batch=1):
            _, fold_cache = model.prefill(pieces["decode"],
                                          {"tokens": toks}, length)
            want, _ = model.decode_step(pieces["decode"], tok, fold_cache, 9)
        bare = model.init_cache(1, length, "cpu")
        calls = {
            "prefill_pieces": ("decode", lambda: model.decode_step(
                pieces["prefill"], tok, fold_cache, 9)),
            "whole_params": ("prefill", lambda: model.prefill(
                whole, {"tokens": toks}, length)),
            "bare_cache": ("decode", lambda: model.decode_step(
                pieces["decode"], tok, bare, 9)),
            "handover": ("decode", lambda: model.decode_step(
                pieces["decode"], tok, cache, 9)),
        }
        for what, (phase, fn) in calls.items():
            try:
                with sv.use_tp_serving(mesh, phase, batch=1):
                    got, _ = fn()
                out[f"{arch}/{what}"] = None
                if what == "handover":
                    out[f"{arch}/handover_logits"] = (got.float().numpy(),
                                                      want.float().numpy())
            except (NotImplementedError, ValueError) as e:
                out[f"{arch}/{what}"] = (type(e).__name__, str(e))
    return out


KINDS = {"loss": loss_case, "per_shard": per_shard_case, "toy": toy_case,
         "layer": layer_case, "trainer": trainer_case,
         "restore": restore_case, "ring_core": ring_core_case,
         "ring_model": ring_model_case, "ring_refusals": ring_refusals_case,
         "tp_serve": tp_serve_case, "tp_refusals": tp_refusals_case,
         "tp_layout": tp_layout_case}


def world(device, cases):
    """One rank: every case on its mesh, in order."""
    meshes = {}
    out = {}
    for name, c in cases:
        key = tuple(c["mesh"].items())
        if key not in meshes:
            meshes[key] = Mesh(c["mesh"], device=device)
        out[name] = KINDS[c["kind"]](meshes[key], c)
    return out if torch.distributed.get_rank() == 0 else None


def main(n, in_path, out_path, timeout=240.0):
    """Run the cases pickled at ``in_path`` on ``n`` CPU ranks; pickle
    rank 0's results to ``out_path``."""
    with open(in_path, "rb") as f:
        cases = pickle.load(f)
    res = launch_ranks(world, n, cases, device="cpu", timeout=timeout)
    with open(out_path, "wb") as f:
        pickle.dump(res[0], f)


class World:
    """Cases running on ``n`` ranks in a subprocess with its own timeout,
    started at construction; ``result()`` waits and returns rank 0's
    results by case name."""

    def __init__(self, n, cases, timeout=300):
        import os
        import pathlib
        import subprocess
        here = pathlib.Path(__file__).resolve().parent
        self.tmp = tempfile.TemporaryDirectory()
        self.src = os.path.join(self.tmp.name, "in.pkl")
        self.dst = os.path.join(self.tmp.name, "out.pkl")
        with open(self.src, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(here.parent / "src"), str(here)]), OMP_NUM_THREADS="1")
        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import _torch_dist_cases as c; "
             f"c.main({n}, {self.src!r}, {self.dst!r}, {timeout - 30})"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def result(self):
        import subprocess
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, err = self.proc.communicate()
            raise AssertionError(f"ranks past {self.timeout} s:\n"
                                 f"{out[-3000:]}{err[-3000:]}")
        try:
            assert self.proc.returncode == 0, out[-4000:] + err[-4000:]
            with open(self.dst, "rb") as f:
                return pickle.load(f)
        finally:
            self.tmp.cleanup()


def run_world(n, cases, timeout=300):
    """``World(n, cases).result()``."""
    return World(n, cases, timeout).result()
