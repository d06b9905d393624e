"""Core datatypes of the port (counterpart of ``repro/core/types.py``).

Shapes use the paper's notation: S task types, M machines, N tasks, Q
local-queue slots. The port adds an explicit leading batch dim B where
the JAX package relied on ``vmap``: every per-trace tensor below carries
it once it is inside the engine.

Only the flat, single-site system is covered: ``SystemSpec`` has no site
or tier partition, and ``SimState`` has none of the fault, federation or
network fields.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Task status codes, the same values as the JAX package's.
UNARRIVED = 0   # not yet arrived
PENDING = 1     # in the arriving queue (arrived, unmapped)
QUEUED = 2      # in a machine's local queue
RUNNING = 3     # executing
COMPLETED = 4   # finished on time
MISSED = 5      # started execution but killed at its deadline
CANCELLED = 6   # dropped before being assigned (proactive drop / stale / victim)


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """A heterogeneous edge system: machines + profiling data.

    eet:    (S, M) expected execution time of task type i on machine j.
    p_dyn:  (M,) dynamic power of each machine.
    p_idle: (M,) idle power of each machine.
    queue_size: local queue slots per machine.
    fairness_factor: ``f`` in Eq. 3.
    """

    eet: np.ndarray
    p_dyn: np.ndarray
    p_idle: np.ndarray
    queue_size: int = 2
    fairness_factor: float = 1.0

    def as_torch(self, device) -> "SystemArrays":
        """The float32 tensors the engine and the policies read."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return SystemArrays(eet=f32(self.eet), p_dyn=f32(self.p_dyn),
                            p_idle=f32(self.p_idle))


class SystemArrays(NamedTuple):
    """Device-side mirror of :class:`SystemSpec`, shared by the batch."""

    eet: torch.Tensor     # (S, M) f32
    p_dyn: torch.Tensor   # (M,) f32
    p_idle: torch.Tensor  # (M,) f32


class Trace(NamedTuple):
    """A workload trace of N arrival-sorted tasks, or a stack of them.

    One trace has leaves (N,) and (N, M); a batch carries leading dims.
    """

    arrival: torch.Tensor      # (..., N) f32
    task_type: torch.Tensor    # (..., N) int64
    deadline: torch.Tensor     # (..., N) f32  (Eq. 4)
    exec_actual: torch.Tensor  # (..., N, M) f32 actual runtimes


class MapAction(NamedTuple):
    """Output of a mapping policy at one mapping event, batched over B."""

    assign: torch.Tensor      # (B, M) int64 task index per machine, -1 = none
    drop: torch.Tensor        # (B, N) bool proactive drops
    queue_drop: torch.Tensor  # (B, M, Q) bool victims evicted (FELARE)


class SimState(NamedTuple):
    """The batched event-loop state: the JAX ``SimState``'s flat fields,
    each with a leading replicate dim B. Every update goes through
    ``where(active, new, old)``, so a replicate whose loop has ended stays
    as it was, as under ``jax.vmap`` of the reference's ``while_loop``.
    """

    now: torch.Tensor          # (B,) f32
    status: torch.Tensor       # (B, N) int64
    run_task: torch.Tensor     # (B, M) int64, -1 idle
    run_start: torch.Tensor    # (B, M) f32
    run_end_act: torch.Tensor  # (B, M) f32 actual completion (inf if idle)
    run_end_exp: torch.Tensor  # (B, M) f32 expected completion
    run_success: torch.Tensor  # (B, M) bool
    queue: torch.Tensor        # (B, M, Q) int64, -1 empty
    qlen: torch.Tensor         # (B, M) int64
    busy_time: torch.Tensor    # (B, M) f32
    e_dyn: torch.Tensor        # (B,) f32
    e_wasted: torch.Tensor     # (B,) f32
    completed: torch.Tensor    # (B, S) int64
    missed: torch.Tensor       # (B, S) int64
    cancelled: torch.Tensor    # (B, S) int64
    arrived: torch.Tensor      # (B, S) int64
    steps: torch.Tensor        # (B,) int64


class Metrics(NamedTuple):
    """Aggregate results of simulated traces (leading batch dims kept)."""

    completed_by_type: torch.Tensor  # (..., S)
    missed_by_type: torch.Tensor     # (..., S)
    cancelled_by_type: torch.Tensor  # (..., S)
    arrived_by_type: torch.Tensor    # (..., S)
    energy_dynamic: torch.Tensor     # (...,) total dynamic energy
    energy_wasted: torch.Tensor      # (...,) dynamic energy of missed tasks
    energy_idle: torch.Tensor        # (...,) idle energy over the makespan
    makespan: torch.Tensor           # (...,) time of the last event
