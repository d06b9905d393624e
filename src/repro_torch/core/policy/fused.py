"""Fused-kernel mapping: the whole per-event decision in one kernel pass.

Counterpart of ``repro/core/policy/fused.py``. :class:`FusedMapPolicy`
wraps a composed two-phase policy (optionally fairness-wrapped) and
replaces its multi-op ``select`` with the ``kernels/map_fused`` wrappers:

  * non-fair: one ``map_decide`` pass gives the drop mask and the
    per-machine Phase-II argmins; the assignment is a short epilogue
    over the (B, M) outputs.
  * fair (FELARE): an ``evict_stats`` pass gives the two per-task grid
    reductions the Sec. V eviction planner needs; the shared
    ``fair._plan_eviction_from_stats`` plans the eviction, and
    ``map_decide`` then runs against the post-eviction view with the
    suffered split live.

The drop rule reads no machine state, so computing it inside the
post-eviction pass equals ``drop_rule.drop(ctx)`` on the pre-eviction
context. On CPU tensors the wrappers run their plain versions; on CUDA
tensors they launch the kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policy import fair as fair_mod
from repro_torch.core.policy.base import PolicyDesc, finalize
from repro_torch.core.policy.context import BIG, MachineView, SchedContext
from repro_torch.core.types import MapAction, SystemArrays
from repro_torch.kernels import map_fused
from repro_torch.kernels.map_fused.ops import (
    DROP_KINDS,
    KEY_KINDS,
    NOMINATOR_KINDS,
)


def supports_fused_map(desc: PolicyDesc) -> bool:
    """Is this composed policy within the fused kernel's kind space?"""
    return (desc.nominator in NOMINATOR_KINDS
            and desc.phase2_key in KEY_KINDS
            and desc.drop_rule in DROP_KINDS)


@dataclasses.dataclass(frozen=True)
class FusedMapPolicy:
    """A composed policy whose map decision runs as one fused kernel pass."""

    base: object

    def __post_init__(self):
        desc = self.base.describe()
        if not supports_fused_map(desc):
            raise ValueError(
                f"fused map kernel does not implement {desc!r}; "
                f"use with_fused_map() which no-ops on unsupported policies"
            )

    def select(self, ctx: SchedContext) -> MapAction:
        desc = self.base.describe()
        if desc.fairness:
            task_feas_now, min_exec = map_fused.evict_stats(
                ctx.start, ctx.qfree, ctx.sysarr.eet, ctx.deadline,
                ctx.pending, ctx.types32)
            qdrop = fair_mod._plan_eviction_from_stats(
                ctx, task_feas_now, min_exec)
            ctx2 = ctx.with_view(fair_mod._evicted_view(ctx, qdrop))
            suffered_task = ctx.suffered_tasks
        else:
            qdrop = None
            ctx2 = ctx
            # Empty hi pool: the epilogue is the plain Phase-II argmin.
            suffered_task = torch.zeros_like(ctx.pending)

        drop, hi_key, hi_task, lo_key, lo_task = map_fused.map_decide(
            ctx.now, ctx2.start, ctx.sysarr.p_dyn, ctx2.qfree,
            ctx.sysarr.eet, ctx.deadline, ctx.pending, ctx.types32,
            suffered_task, nominator=desc.nominator,
            phase2_key=desc.phase2_key, drop_rule=desc.drop_rule)

        # Priority Phase II over the per-machine argmins (== base.phase2
        # and fair.py's hi-then-lo chain).
        qfree2 = ctx2.qfree
        assign_hi = torch.where((hi_key < BIG) & qfree2, hi_task, -1)
        taken = assign_hi >= 0
        assign_lo = torch.where((lo_key < BIG) & qfree2 & ~taken, lo_task, -1)
        assign = torch.where(taken, assign_hi, assign_lo)
        return finalize(ctx, assign, drop, qdrop)

    def __call__(self, now, pending, task_type, deadline, view: MachineView,
                 sysarr: SystemArrays, suffered,
                 task_type32=None) -> MapAction:
        return self.select(SchedContext(
            now, pending, task_type, deadline, view, sysarr, suffered,
            task_type32
        ))

    def describe(self) -> PolicyDesc:
        return self.base.describe()

    @property
    def supports_phase1_impl(self) -> bool:
        # Phase I is already inside the fused kernel.
        return False

    def with_phase1_impl(self, impl) -> "FusedMapPolicy":
        return self
