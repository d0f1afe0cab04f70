"""Training loop: data + step + checkpoints + fault tolerance.

The reference's loop (``repro.train.trainer``).  It auto-resumes from
the newest checkpoint, saves through an async ``CheckpointManager``
every ``ckpt_every`` steps (the writes overlap the next train steps),
and feeds the straggler monitor.

On a mesh (``launch.mesh``; every rank calls ``train``) the mesh decides
the stage count and the data shards of ``TrainPlan.for_shape``, each
rank holds its pieces of the state (``train_step.init_state(mesh=)``)
and reads the whole batch.  A checkpoint is written in the reference's
format, whole leaves gathered to rank 0, which alone owns the directory
and writes the metrics; every rank restores the newest one and cuts its
pieces, so a run resumes on any mesh or none (the reference's elastic
restore), and a run without a mesh resumes a mesh's.

Checkpoints carry more than the train state: the payload is
``{"state": ..., "extra": {"data": ..., "rng": ...}}``, where ``extra``
records the data iterator's geometry (seed, next step, global batch,
seq len) and the key the run was seeded with (``jax.random.key(seed)``'s
two uint32 words).  The data pipeline is stateless (``batch_at`` is a
pure function of seed and step), so that geometry IS the iterator's
state: restore checks it against the run's config and resumes at the
recorded step.  The payload and its layout on disk are the reference's,
so either package resumes the other's run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.obs import JsonlLogger, MetricsRegistry
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerMonitor)
from repro_torch.serve.sampling import seed_key
from repro_torch.launch.mesh import mesh_axis_size
from repro_torch.train.train_step import (TrainPlan, check_mesh,
                                          gather_state, init_state,
                                          make_train_step, mesh_device,
                                          shard_state)

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    metrics_path: Optional[str] = None   # JSONL telemetry (repro_torch.obs)
    ckpt_async: bool = True              # overlap writes with train steps
    ckpt_max_in_flight: int = 2          # bounded writer queue (backpressure)
    ckpt_compress_opt: bool = True       # int8_ef-compress optimizer moments
    ckpt_write_throttle_s: float = 0.0   # test/chaos knob: slow the writer


def _payload(state, dcfg: DataConfig, next_step: int, seed: int):
    """Checkpoint payload: train state + data-iterator state + RNG key."""
    return {"state": state,
            "extra": {"data": torch.tensor(
                          [dcfg.seed, next_step, dcfg.global_batch,
                           dcfg.seq_len], dtype=torch.int64),
                      "rng": seed_key(seed)[0].to(torch.uint32)}}


def train(model, cfg: ModelConfig, shape: ShapeConfig,
          tcfg: TrainerConfig, opt_cfg: Optional[OptimizerConfig] = None,
          injector: Optional[FailureInjector] = None,
          step_fn=None, state=None, start_step: int = 0,
          on_metrics: Optional[Callable[[int, Dict], None]] = None,
          mesh=None, obs=None, device="cuda"):
    """Returns (state, history).  Restartable: call again after a crash
    and it resumes from the newest checkpoint in ``tcfg.ckpt_dir``.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``"cpu"`` is asked for; on a ``mesh`` it must be the mesh's device
    (a CPU mesh needs ``device="cpu"`` here too).  A mesh with a "stage" axis trains pipelined at its stage
    count (the decoder family only, as in the reference), a stage-free
    one data and tensor parallel.  The data pipeline's batches carry
    tokens only, so whisper's loss raises its ``KeyError`` for the
    missing "frames" at the first step, as the reference's trainer fails.
    """
    stages = mesh_axis_size(mesh, "stage") if mesh is not None else 1
    if mesh is not None:
        check_mesh(model, mesh, stages)
        dev = mesh_device(mesh, device)
    else:
        dev = resolve_device(device)
    lead = mesh is None or mesh.position == 0
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=tcfg.total_steps,
                                         warmup_steps=5)
    plan = TrainPlan.for_shape(
        cfg, shape, data_shards=mesh_axis_size(mesh, "data") if mesh
        is not None else 1, pipeline_stages=stages)
    if step_fn is None:
        step_fn = make_train_step(model, opt_cfg, plan, mesh=mesh)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=tcfg.seed)

    manager = None
    if tcfg.ckpt_dir and lead:
        manager = CheckpointManager(
            tcfg.ckpt_dir, keep=tcfg.keep,
            max_in_flight=tcfg.ckpt_max_in_flight,
            compress_opt_state=tcfg.ckpt_compress_opt,
            write_throttle_s=tcfg.ckpt_write_throttle_s, obs=obs)

    # start_step only applies to caller-supplied state (e.g. continuing a
    # returned state mid-schedule); the restore path derives its own start
    start = start_step if state is not None else 0
    if state is None:
        state = init_state(model, tcfg.seed, opt_cfg, dev, mesh=mesh)
        ckpt_step = (ckpt.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir
                     else None)
        if ckpt_step is not None:
            like = _payload(state, dcfg, 0, tcfg.seed)
            if manager is not None:
                payload, ckpt_step = manager.restore(like, step=ckpt_step)
            else:    # a rank that does not own the directory reads it
                payload = ckpt.restore(tcfg.ckpt_dir, ckpt_step, like)
            geom = payload["extra"]["data"].tolist()
            saved = (geom[0], geom[2], geom[3])
            want = (dcfg.seed, dcfg.global_batch, dcfg.seq_len)
            if saved != want:
                raise ValueError(
                    f"checkpoint data geometry {saved} != run {want} "
                    "(seed, global_batch, seq_len); refusing to resume "
                    "onto a different data stream")
            state = (tree_map(lambda t: t.to(dev), payload["state"])
                     if mesh is None else
                     shard_state(payload["state"], model, mesh, dev))
            start = geom[1]
            if start != ckpt_step:
                raise ValueError(f"checkpoint of step {ckpt_step} records "
                                 f"next step {start}")
    monitor = StragglerMonitor()
    logger = JsonlLogger(tcfg.metrics_path if lead else None)

    def save(step: int, blocking: bool) -> None:
        whole = state if mesh is None else gather_state(state, model, mesh,
                                                        keep=lead)
        if manager is not None:
            manager.save(step, _payload(whole, dcfg, step, tcfg.seed),
                         blocking=blocking)

    registry = obs.registry if obs is not None else MetricsRegistry()
    tracer = obs.tracer if obs is not None else None
    _span = (tracer.span if tracer is not None
             else lambda *a, **kw: contextlib.nullcontext())
    history = []
    try:
        for step in range(start, tcfg.total_steps):
            if injector is not None:
                injector.maybe_fail(step)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_at(dcfg, step).items()}
            # perf_counter for the duration (the wall clock can be
            # stepped mid-step); the logger stamps the one wall time each
            # record keeps
            t0 = time.perf_counter()
            with _span("train_step", step=step + 1):
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if manager is not None:
                manager.step_completed()
            straggler = monitor.observe(step, dt)
            logger.log(step + 1, loss=loss, dt=dt,
                       grad_norm=metrics.get("grad_norm", 0.0),
                       straggler=straggler)
            registry.counter("train.steps")
            registry.observe("train.step_time_s", dt)
            registry.gauge("train.loss", loss)
            if straggler:
                registry.counter("train.straggler_events")
                if tracer is not None:
                    tracer.instant("straggler", step=step + 1, dt=dt)
            history.append({"step": step + 1, "loss": loss, "dt": dt})
            if on_metrics and lead:
                on_metrics(step + 1, metrics)
            if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
                with _span("checkpoint", step=step + 1):
                    save(step + 1, blocking=not tcfg.ckpt_async)
                registry.counter("train.checkpoints")
        if tcfg.ckpt_dir and tcfg.total_steps > start:
            # blocking final save: the manager drains the async queue
            # first, so this never interleaves with an in-flight write
            with _span("checkpoint", step=tcfg.total_steps, final=True):
                save(tcfg.total_steps, blocking=True)
            registry.counter("train.checkpoints")
    finally:
        if manager is not None:
            # join the writer even on a crash or injected failure, so that
            # a restart (possibly this same process) sees a quiescent
            # directory; a secondary writer error must not mask the
            # primary exception already propagating
            in_flight = sys.exc_info()[0] is not None
            try:
                manager.close()
            except Exception:
                if not in_flight:
                    raise
        logger.close()
    return state, history
