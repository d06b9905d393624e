"""Fault-tolerant training loop: checkpoint/restart and failure injection
(counterpart of ``repro/train/loop.py``).

The loop is restart-idempotent: a batch is a pure function of the step
(``SyntheticLM``), checkpoints are atomic and taken at step boundaries,
and ``run_with_restarts`` restarts an incarnation that failed from the
last checkpoint. A ``SimulatedFailure`` at a checkpoint boundary loses no
work, and the run ends with the parameters of an uninterrupted one, bit
for bit where the device's arithmetic is deterministic (always on the
CPU; on the card under ``torch.use_deterministic_algorithms``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.device import resolve_device
from repro_torch.datapipe.synthetic import SyntheticLM
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW
from repro_torch.train.steps import make_train_step


class SimulatedFailure(RuntimeError):
    """Injected preemption (a 'node failure' in the dry-run environment)."""


@dataclasses.dataclass
class TrainJob:
    cfg: object
    steps: int
    batch: int = 4
    seq: int = 32
    accum: int = 1
    lr: float = 1e-3
    ckpt_dir: str | None = None
    ckpt_every: int = 10
    ckpt_async: bool = True
    seed: int = 0
    mesh: object = None
    log_every: int = 10
    device: object = None       # None = CUDA (raises without one)


def run(job: TrainJob, *, fail_at: dict[int, Exception] | None = None,
        on_step: Callable | None = None):
    """One incarnation: restores from the latest checkpoint if present,
    trains to ``job.steps``, checkpoints every ``job.ckpt_every`` steps
    and at the end. Raises the injected failure if the plan says so
    (preemption mid-run). Returns (params, opt_state, history)."""
    if job.mesh is not None:
        raise NotImplementedError(
            "mesh-sharded loop is exercised via launch/train.py")
    cfg = job.cfg
    opt = AdamW(lr=job.lr)
    data = SyntheticLM(cfg, batch=job.batch, seq=job.seq, seed=job.seed,
                       accum=job.accum)
    step_fn = make_train_step(cfg, opt, job.mesh, donate=False,
                              device=job.device)
    dev = resolve_device(job.device)

    start = 0
    if job.ckpt_dir is not None and ckpt.latest_step(job.ckpt_dir) is not None:
        target = tf.param_shapes(cfg)
        state, start = ckpt.restore(
            job.ckpt_dir, {"p": target, "o": opt.init(target)}, device=dev)
        params, opt_state = state["p"], state["o"]
    else:
        gen = torch.Generator(device=dev).manual_seed(job.seed)
        params = tf.init(cfg, gen, device=dev)
        opt_state = opt.init(params)

    history = []
    pending_save = None
    try:
        for step in range(start, job.steps):
            if fail_at and step in fail_at:
                raise fail_at.pop(step)
            batch = data.batch_at(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"])})
            if on_step:
                on_step(step, history[-1])
            if job.ckpt_dir is not None and \
                    (step + 1) % job.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(
                    job.ckpt_dir, step + 1, {"p": params, "o": opt_state},
                    blocking=not job.ckpt_async)
    finally:
        # an incarnation that fails still lands its last async save, so
        # the restart finds it
        if pending_save is not None:
            pending_save.join()
    if job.ckpt_dir is not None:
        ckpt.save(job.ckpt_dir, job.steps, {"p": params, "o": opt_state})
    return params, opt_state, history


def run_with_restarts(job: TrainJob, *, failures: dict[int, Exception],
                      max_restarts: int = 8):
    """The supervisor: restart from the checkpoint on a (simulated) node
    failure. Returns (params, opt_state, history, restarts)."""
    attempts = 0
    history = []
    while True:
        try:
            params, opt_state, h = run(job, fail_at=failures)
            history.extend(h)
            return params, opt_state, history, attempts
        except SimulatedFailure:
            attempts += 1
            if attempts > max_restarts:
                raise
            time.sleep(0.01)
