"""Scheduling context: everything a mapping policy may look at, computed once.

Counterpart of ``repro/core/policy/context.py``, batched: every field
carries a leading dim B (one mapping event per replicate). The EET table
and the power profiles are either shared by the batch ((S, M) and (M,))
or given per row ((B, S, M) and (B, M)), as the engine does for the
federation's site views. Derived grids are ``cached_property``s, so one
event computes each grid once however many policy components read it.

Shapes: B replicates, N tasks, M machines, Q local-queue slots, S types.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.eet import eet_at, type_rows
from repro_torch.core.equations import BIG, seq_sum
from repro_torch.core.types import SystemArrays

__all__ = ["BIG", "MachineView", "SchedContext", "avail_time", "queued_eet"]


class MachineView(NamedTuple):
    """Scheduler-visible machine state at a mapping event."""

    avail_base: torch.Tensor  # (B, M) max(now, expected end of running task)
    queue: torch.Tensor       # (B, M, Q) int64 task idx, -1 = empty, FCFS
    qlen: torch.Tensor        # (B, M) int64


def queued_eet(view: MachineView, task_type, sysarr: SystemArrays):
    """(B, M, Q) expected execution time of each queued task on its machine."""
    B, M, Q = view.queue.shape
    occ = view.queue >= 0
    idx = view.queue.clamp(min=0).reshape(B, M * Q)
    ttype = torch.where(occ, task_type.gather(1, idx).reshape(B, M, Q), 0)
    cols = torch.arange(M, device=ttype.device)[None, :, None]
    e = eet_at(sysarr.eet, ttype, cols)
    return torch.where(occ, e, torch.zeros_like(e))


def avail_time(view: MachineView, task_type, sysarr: SystemArrays):
    """(B, M) expected time each machine can start a newly-appended task."""
    return view.avail_base + seq_sum(queued_eet(view, task_type, sysarr))


@dataclasses.dataclass(frozen=True)
class SchedContext:
    """Frozen snapshot of one batched mapping event."""

    now: torch.Tensor        # (B,) f32 current event time
    pending: torch.Tensor    # (B, N) bool — task is in the arriving queue
    task_type: torch.Tensor  # (B, N) int64, the form indexing takes
    deadline: torch.Tensor   # (B, N) f32
    view: MachineView
    sysarr: SystemArrays
    suffered: torch.Tensor   # (B, S) bool — fairness monitor (Alg. 4)
    #: (B, N) int32 copy of ``task_type``, the form the kernels take; the
    #: engine builds it once per simulation. ``None``: :attr:`types32`
    #: casts on first use.
    task_type32: Optional[torch.Tensor] = None

    # -- static shapes ------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return self.pending.shape[1]

    @property
    def n_machines(self) -> int:
        return self.sysarr.eet.shape[-1]

    @property
    def queue_slots(self) -> int:
        return self.view.queue.shape[2]

    @functools.cached_property
    def types32(self):
        """(B, N) int32 task types for the kernels."""
        if self.task_type32 is not None:
            return self.task_type32
        return self.task_type.to(torch.int32)

    # -- derived machine state ---------------------------------------------
    @functools.cached_property
    def qfree(self):
        """(B, M) bool — machine has at least one free local-queue slot."""
        return self.view.qlen < self.queue_slots

    @functools.cached_property
    def avail(self):
        """(B, M) f32 — expected start time of a newly-appended task."""
        return avail_time(self.view, self.task_type, self.sysarr)

    @functools.cached_property
    def start(self):
        """(B, M) f32 — mapping-event start times: max(avail, now)."""
        return torch.maximum(self.avail, self.now[:, None])

    @functools.cached_property
    def machine_arange(self):
        """(1, 1, M) int64 — broadcast helper for nominee grids."""
        return torch.arange(self.n_machines,
                            device=self.pending.device)[None, None, :]

    # -- derived (B, N, M) pair grids ---------------------------------------
    @functools.cached_property
    def exec_grid(self):
        """(B, N, M) f32 — expected execution time of each task on each
        machine."""
        return type_rows(self.sysarr.eet, self.task_type)

    @functools.cached_property
    def start_grid(self):
        """(B, N, M) f32 — :attr:`start` broadcast across tasks."""
        return self.start[:, None, :].expand(self.exec_grid.shape)

    # -- derived task masks ------------------------------------------------
    @functools.cached_property
    def stale(self):
        """(B, N) bool — pending and past its deadline (must be purged)."""
        return self.pending & (self.now[:, None] >= self.deadline)

    @functools.cached_property
    def alive(self):
        """(B, N) bool — pending and not yet stale."""
        return self.pending & ~self.stale

    @functools.cached_property
    def min_exec(self):
        """(B, N) f32 — each task's execution time on its fastest machine
        (of the row's own table, so a site view sees only its site)."""
        fastest = self.sysarr.eet.min(dim=-1).values      # (S,) or (B, S)
        if fastest.dim() == 1:
            return fastest[self.task_type]
        return fastest.gather(1, self.task_type)

    @functools.cached_property
    def hopeless(self):
        """(B, N) bool — would miss its deadline even on an idle machine."""
        return self.pending & (self.now[:, None] + self.min_exec
                               > self.deadline)

    @functools.cached_property
    def suffered_tasks(self):
        """(B, N) bool — pending tasks whose type is currently suffered."""
        return self.suffered.gather(1, self.task_type) & self.pending

    # -- derived contexts --------------------------------------------------
    def with_view(self, view: MachineView) -> "SchedContext":
        """A fresh context over modified machine state (post-eviction)."""
        return dataclasses.replace(self, view=view)

    def with_qfree(self, qfree) -> "SchedContext":
        """A fresh context whose free-slot mask is overridden (for the
        legacy ``elare_phase1`` callers that compute ``qfree``
        themselves)."""
        ctx = dataclasses.replace(self)
        ctx.__dict__["qfree"] = qfree
        return ctx
