"""The composable scheduling-policy algebra, batched.

Counterpart of ``repro/core/policy/base.py``: a policy is a
:class:`Nominator` (Phase I) x :class:`Phase2Key` (Phase II) x
:class:`DropRule`, optionally wrapped by ``with_fairness``. Every tensor
carries a leading batch dim B.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Protocol

import torch

from repro_torch.core.policy.context import BIG, MachineView, SchedContext
from repro_torch.core.types import MapAction, SystemArrays


class Nomination(NamedTuple):
    """Phase-I output: one nominated machine per task.

    best_machine: (B, N) int64 (garbage where ``valid`` is False).
    value: (B, N) f32 — the quantity Phase I minimized; BIG where invalid.
    valid: (B, N) bool — task produced a nomination this event.
    """

    best_machine: torch.Tensor
    value: torch.Tensor
    valid: torch.Tensor

    def grid(self, ctx: SchedContext) -> torch.Tensor:
        """(B, N, M) bool nominee grid: task i nominates machine j."""
        return self.valid[:, :, None] & (
            self.best_machine[:, :, None] == ctx.machine_arange
        )


class Nominator(Protocol):
    kind: str

    def nominate(self, ctx: SchedContext) -> Nomination: ...


class Phase2Key(Protocol):
    kind: str

    def key(self, ctx: SchedContext, nom: Nomination) -> torch.Tensor: ...


class DropRule(Protocol):
    kind: str

    def drop(self, ctx: SchedContext) -> torch.Tensor: ...


class PolicyDesc(NamedTuple):
    """Declarative description of a composed policy."""

    nominator: str
    phase2_key: str
    drop_rule: str
    fairness: bool = False
    backup_k: int = 0  # k-failure backup nominations (faults.with_backup)


def phase2(nominee: torch.Tensor, key: torch.Tensor, qfree: torch.Tensor):
    """Algorithm 3: per machine pick the nominee with the minimum key.

    nominee: (B, N, M) bool, key: (B, N) f32 (lower = better),
    qfree: (B, M) bool. Returns assign (B, M) int64 task index or -1.
    Ties go to the lowest task index.
    """
    masked = torch.where(nominee, key[:, :, None],
                         torch.full((), BIG, device=key.device))
    best_key, best_task = masked.min(dim=1)
    has = (best_key < BIG) & qfree
    return torch.where(has, best_task, -1)


def set_masked(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
               value) -> torch.Tensor:
    """``x[b, idx[b, j]] = value`` where ``mask[b, j]``, as a new tensor.

    The counterpart of JAX's ``x.at[where(mask, idx, N)].set(value,
    mode="drop")``: masked-out entries are sent to one extra column that
    is cut off afterwards, so they can collide with nothing. ``x`` is
    (B, N), ``idx`` and ``mask`` are (B, K) and ``value`` a scalar or a
    (B, K) tensor.
    """
    B, N = x.shape
    out = torch.cat([x, x.new_zeros((B, 1))], dim=1)
    out.scatter_(1, torch.where(mask, idx, N), value)
    return out[:, :N]


def finalize(ctx: SchedContext, assign: torch.Tensor, drop: torch.Tensor,
             queue_drop: Optional[torch.Tensor] = None) -> MapAction:
    """Shared epilogue: never drop a task assigned this very event."""
    assigned = set_masked(torch.zeros_like(ctx.pending), assign, assign >= 0,
                          True)
    if queue_drop is None:
        queue_drop = torch.zeros(ctx.view.queue.shape, dtype=torch.bool,
                                 device=assign.device)
    return MapAction(assign, drop & ~assigned, queue_drop)


@dataclasses.dataclass(frozen=True)
class TwoPhasePolicy:
    """nominator x phase2_key x drop_rule — the paper's two-phase template."""

    nominator: Nominator
    phase2_key: Phase2Key
    drop_rule: DropRule

    def select(self, ctx: SchedContext) -> MapAction:
        nom = self.nominator.nominate(ctx)
        assign = phase2(nom.grid(ctx), self.phase2_key.key(ctx, nom),
                        ctx.qfree)
        return finalize(ctx, assign, self.drop_rule.drop(ctx))

    def __call__(self, now, pending, task_type, deadline, view: MachineView,
                 sysarr: SystemArrays, suffered,
                 task_type32=None) -> MapAction:
        return self.select(SchedContext(
            now, pending, task_type, deadline, view, sysarr, suffered,
            task_type32
        ))

    def describe(self) -> PolicyDesc:
        return PolicyDesc(self.nominator.kind, self.phase2_key.kind,
                          self.drop_rule.kind, fairness=False)

    @property
    def supports_phase1_impl(self) -> bool:
        return hasattr(self.nominator, "with_impl")

    def with_phase1_impl(self, impl) -> "TwoPhasePolicy":
        """Swap the nominator's fused Phase-I implementation (the
        ``phase1_map`` kernel). No-op if the nominator has no hook."""
        if not self.supports_phase1_impl:
            return self
        return dataclasses.replace(
            self, nominator=self.nominator.with_impl(impl)
        )
