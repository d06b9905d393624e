"""Concrete policy pieces: Phase-I nominators, Phase-II keys, drop rules.

Counterpart of ``repro/core/policy/components.py``, batched over B.
Every piece is a frozen dataclass carrying the same ``kind`` tag as its
JAX twin, and every expression mirrors it op for op: float32, one
rounding per operation, lowest-index argmin on ties.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import equations
from repro_torch.core.policy.base import Nomination
from repro_torch.core.policy.context import BIG, SchedContext


def _masked_argmin(mask: torch.Tensor, score: torch.Tensor):
    """Per task (B, N): min and lowest-index argmin over M of
    ``where(mask, score, BIG)``."""
    masked = torch.where(mask, score, torch.full((), BIG, device=score.device))
    value, best = masked.min(dim=2)
    return best, value


# --------------------------------------------------------------------------
# Phase-I nominators
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MinEnergyFeasible:
    """ELARE Phase-I (Alg. 2): min-energy machine among feasible pairs.

    ``impl`` optionally replaces the inner computation — the
    ``phase1_map`` kernel plugs in here (contract:
    ``impl(start, exec_grid, deadline, p_dyn, pending, qfree)
    -> (best_machine, best_energy)``).
    """

    kind = "min_energy_feasible"
    impl: Optional[Callable] = None

    def with_impl(self, impl) -> "MinEnergyFeasible":
        return dataclasses.replace(self, impl=impl)

    def nominate(self, ctx: SchedContext) -> Nomination:
        if self.impl is not None:
            best_m, best_ec = self.impl(
                ctx.start, ctx.exec_grid, ctx.deadline, ctx.sysarr.p_dyn,
                ctx.pending, ctx.qfree,
            )
        else:
            s, e, d = ctx.start_grid, ctx.exec_grid, ctx.deadline[:, :, None]
            feas = (equations.feasible(s, e, d)
                    & ctx.pending[:, :, None] & ctx.qfree[:, None, :])
            ec = equations.expected_energy(s, e, d,
                                           ctx.sysarr.p_dyn.unsqueeze(-2))
            best_m, best_ec = _masked_argmin(feas, ec)
        return Nomination(best_m, best_ec, best_ec < BIG)


@dataclasses.dataclass(frozen=True)
class MinCompletion:
    """Baseline Phase-I (MM/MSD/MMU/MCT): min expected completion time."""

    kind = "min_completion"

    def nominate(self, ctx: SchedContext) -> Nomination:
        c = equations.completion_time(
            ctx.start_grid, ctx.exec_grid, ctx.deadline[:, :, None]
        )
        best_m, best_c = _masked_argmin(
            ctx.alive[:, :, None] & ctx.qfree[:, None, :], c)
        return Nomination(best_m, best_c, best_c < BIG)


@dataclasses.dataclass(frozen=True)
class MinExecution:
    """MET Phase-I: the machine with the smallest raw EET entry."""

    kind = "min_execution"

    def nominate(self, ctx: SchedContext) -> Nomination:
        best_m, best_e = _masked_argmin(
            ctx.alive[:, :, None] & ctx.qfree[:, None, :], ctx.exec_grid)
        return Nomination(best_m, best_e, best_e < BIG)


@dataclasses.dataclass(frozen=True)
class RandomMachine:
    """Pseudo-random nomination (hash of task index x event time)."""

    kind = "random_hash"

    def nominate(self, ctx: SchedContext) -> Nomination:
        B, n = ctx.pending.shape
        h = equations.hash_machine(n, ctx.now, ctx.n_machines)
        value = torch.arange(n, device=h.device,
                             dtype=torch.float32).expand(B, n)
        return Nomination(h, value, ctx.alive)


# --------------------------------------------------------------------------
# Phase-II keys (lower = better)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NominationValue:
    """Serve the nominee whose Phase-I value is smallest."""

    kind = "value"

    def key(self, ctx: SchedContext, nom: Nomination) -> torch.Tensor:
        return nom.value


@dataclasses.dataclass(frozen=True)
class SoonestDeadline:
    """MSD: earliest-deadline nominee first, Phase-I value as tie-break."""

    kind = "deadline"

    def key(self, ctx: SchedContext, nom: Nomination) -> torch.Tensor:
        scaled = 1e-6 * nom.value        # separate multiply and add: no FMA
        return ctx.deadline + scaled


@dataclasses.dataclass(frozen=True)
class MaxUrgency:
    """MMU: most-urgent nominee first, urgency = 1/(delta - now - e)."""

    kind = "urgency"

    def key(self, ctx: SchedContext, nom: Nomination) -> torch.Tensor:
        e_best = ctx.exec_grid.gather(2, nom.best_machine[:, :, None])[:, :, 0]
        return -equations.urgency(ctx.deadline, e_best, ctx.now[:, None])


@dataclasses.dataclass(frozen=True)
class Fcfs:
    """First-come-first-served: lowest task index."""

    kind = "fcfs"

    def key(self, ctx: SchedContext, nom: Nomination) -> torch.Tensor:
        B, n = ctx.pending.shape
        return torch.arange(n, device=ctx.pending.device,
                            dtype=torch.float32).expand(B, n)


# --------------------------------------------------------------------------
# Drop rules
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DropStale:
    """Purge only tasks whose deadline already passed (the baselines)."""

    kind = "stale"

    def drop(self, ctx: SchedContext) -> torch.Tensor:
        return ctx.stale


@dataclasses.dataclass(frozen=True)
class DropStaleAndHopeless:
    """ELARE's proactive cancellation (Alg. 1): also drop tasks that would
    miss their deadline even on an instantly-free machine."""

    kind = "stale_hopeless"

    def drop(self, ctx: SchedContext) -> torch.Tensor:
        return ctx.stale | ctx.hopeless
