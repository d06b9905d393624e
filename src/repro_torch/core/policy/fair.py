"""The Sec. V fairness wrapper: suffered-type priority + queue eviction.

Counterpart of ``repro/core/policy/fair.py``, batched over B: each
replicate plans its own eviction (one target task, one machine) and the
tail-first victim walk is the same static loop over the Q slots.
FELARE is exactly ``with_fairness(ELARE)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import equations
from repro_torch.core.eet import eet_at, type_rows
from repro_torch.core.equations import seq_sum
from repro_torch.core.policy.base import (
    PolicyDesc,
    TwoPhasePolicy,
    finalize,
    phase2,
)
from repro_torch.core.policy.context import (
    BIG,
    MachineView,
    SchedContext,
    queued_eet,
)
from repro_torch.core.types import MapAction, SystemArrays


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-replicate gather along dim 1: ``x[b, idx[b]]``."""
    return x.gather(1, idx[:, None])[:, 0]


def _plan_eviction(ctx: SchedContext) -> torch.Tensor:
    """(B, M, Q) bool eviction mask rescuing the most urgent suffered task."""
    s, e, d = ctx.start_grid, ctx.exec_grid, ctx.deadline[:, :, None]
    feas_now = equations.feasible(s, e, d) & ctx.pending[:, :, None]
    task_feas_now = (feas_now & ctx.qfree[:, None, :]).any(dim=2)
    return _plan_eviction_from_stats(ctx, task_feas_now, ctx.min_exec)


def _plan_eviction_from_stats(ctx: SchedContext, task_feas_now, min_exec):
    """Eviction plan from the per-task grid reductions.

    ``task_feas_now`` (B, N) bool and ``min_exec`` (B, N) f32 are the two
    quantities :func:`_plan_eviction` derives from the (B, N, M) grid;
    the fused path computes them with the ``evict_stats`` kernel and
    re-enters here, so target and victim selection is shared.
    """
    B, M, Q = ctx.view.queue.shape
    eet = ctx.sysarr.eet
    now = ctx.now
    rescuable = (
        ctx.suffered_tasks
        & ~task_feas_now
        & (now[:, None] + min_exec <= ctx.deadline)
    )
    cand_key = torch.where(rescuable, ctx.deadline,
                           torch.full((), BIG, device=now.device))
    tgt = cand_key.argmin(dim=1)                                   # (B,)
    have_tgt = _take(cand_key, tgt) < BIG
    tt_tgt = _take(ctx.task_type, tgt)
    dl_tgt = _take(ctx.deadline, tgt)

    # fastest (best-matching) machine for the target: min expected completion.
    comp_tgt = ctx.avail + type_rows(eet, tt_tgt)                  # (B, M)
    mstar = comp_tgt.argmin(dim=1)                                 # (B,)

    # evict non-suffered victims tail-first until the target fits on mstar.
    q_eet = queued_eet(ctx.view, ctx.task_type, ctx.sysarr)        # (B, M, Q)
    pick = mstar[:, None, None].expand(B, 1, Q)
    q_row = q_eet.gather(1, pick)[:, 0]                            # (B, Q)
    row = ctx.view.queue.gather(1, pick)[:, 0]                     # (B, Q)
    occ = row >= 0
    row_type = ctx.task_type.gather(1, row.clamp(min=0))
    victim_ok = occ & ~ctx.suffered.gather(1, row_type)
    e_tgt = eet_at(eet, tt_tgt, mstar)
    base = torch.maximum(_take(ctx.view.avail_base, mstar), now)
    evict = torch.zeros((B, Q), dtype=torch.bool, device=now.device)
    remaining = seq_sum(q_row)
    zero = torch.zeros((), device=now.device)
    for q in range(Q - 1, -1, -1):
        start_if = base + remaining
        need = start_if + e_tgt > dl_tgt
        take = need & victim_ok[:, q]
        evict[:, q] = take
        remaining = remaining - torch.where(take, q_row[:, q], zero)
    feasible_after = base + remaining + e_tgt <= dl_tgt
    evict = evict & (feasible_after & have_tgt)[:, None]  # only if it rescues
    on_mstar = torch.arange(M, device=now.device)[None, :] == mstar[:, None]
    return on_mstar[:, :, None] & evict[:, None, :]


def _evicted_view(ctx: SchedContext, qdrop) -> MachineView:
    """The post-eviction machine view the base policy re-runs against."""
    return MachineView(
        avail_base=ctx.view.avail_base,
        queue=torch.where(qdrop, -1, ctx.view.queue),
        qlen=ctx.view.qlen - qdrop.sum(dim=2),
    )


@dataclasses.dataclass(frozen=True)
class FairnessPolicy:
    """A two-phase policy wrapped with the Sec. V fairness mechanisms."""

    base: TwoPhasePolicy

    def select(self, ctx: SchedContext) -> MapAction:
        qdrop = _plan_eviction(ctx)

        # Re-run the base policy's Phase I against post-eviction state.
        ctx2 = ctx.with_view(_evicted_view(ctx, qdrop))
        nom = self.base.nominator.nominate(ctx2)
        nominee = nom.grid(ctx2)
        key = self.base.phase2_key.key(ctx2, nom)

        # Priority Phase II: suffered-type nominees claim machines first.
        suff = ctx.suffered_tasks[:, :, None]
        assign_hi = phase2(nominee & suff, key, ctx2.qfree)
        taken = assign_hi >= 0
        assign_lo = phase2(nominee & ~suff, key, ctx2.qfree & ~taken)
        assign = torch.where(taken, assign_hi, assign_lo)
        return finalize(ctx, assign, self.base.drop_rule.drop(ctx), qdrop)

    def __call__(self, now, pending, task_type, deadline, view: MachineView,
                 sysarr: SystemArrays, suffered,
                 task_type32=None) -> MapAction:
        return self.select(SchedContext(
            now, pending, task_type, deadline, view, sysarr, suffered,
            task_type32
        ))

    def describe(self) -> PolicyDesc:
        return self.base.describe()._replace(fairness=True)

    @property
    def supports_phase1_impl(self) -> bool:
        return self.base.supports_phase1_impl

    def with_phase1_impl(self, impl) -> "FairnessPolicy":
        return dataclasses.replace(
            self, base=self.base.with_phase1_impl(impl)
        )


def with_fairness(base: TwoPhasePolicy) -> FairnessPolicy:
    """Wrap ``base`` with suffered-type priority + queue eviction (Sec. V)."""
    return FairnessPolicy(base)
