"""Deprecation shim over :mod:`repro_torch.core.policy` (counterpart of
``repro/core/heuristics.py``).

The eight paper heuristics are compositions over the policy algebra
(Phase-I nominators x Phase-II keys x drop rules, with FELARE =
``with_fairness(ELARE)``). This module keeps the legacy surface:

  * ``get(name)`` / ``HEURISTICS``: views over the mutable policy
    registry, so user-registered policies appear here too;
  * ``elare_select`` / ``felare_select`` / ...: the per-heuristic
    callables (the ELARE pair keeps its ``phase1_impl`` keyword);
  * ``MachineView`` / ``queued_eet`` / ``avail_time`` / ``elare_phase1``:
    re-exports for engine and kernel-test consumers.

Every callable is batched, as the port's policies are. New code should
import from :mod:`repro_torch.core.policy` directly.
"""
from __future__ import annotations

from typing import Callable, Iterator, Mapping

import torch

from repro_torch.core import policy
from repro_torch.core.policy import (  # re-exported legacy surface
    BIG,
    MachineView,
    SchedContext,
    avail_time,
    queued_eet,
)
from repro_torch.core.types import MapAction

__all__ = [
    "BIG",
    "HEURISTICS",
    "MachineView",
    "SchedContext",
    "avail_time",
    "elare_phase1",
    "elare_select",
    "felare_select",
    "get",
    "mct_select",
    "met_select",
    "mm_select",
    "mmu_select",
    "msd_select",
    "queued_eet",
    "random_select",
]


def get(name: str) -> Callable:
    """Resolve a mapping policy by name (deprecated: use ``policy.get``)."""
    return policy.get(name)


class _RegistryView(Mapping):
    """Live read-only mapping view of the policy registry (the legacy
    ``HEURISTICS`` dict surface: iteration, ``in``, ``.values()``...)."""

    def __getitem__(self, name: str):
        return policy.get(name)

    def __iter__(self) -> Iterator[str]:
        return iter(policy.list_policies())

    def __len__(self) -> int:
        return len(policy.list_policies())

    def __repr__(self) -> str:
        return f"HEURISTICS({policy.list_policies()})"


HEURISTICS: Mapping[str, Callable] = _RegistryView()


# --------------------------------------------------------------------------
# Legacy per-heuristic callables.
# --------------------------------------------------------------------------
def elare_select(now, pending, task_type, deadline, view, sysarr, suffered,
                 *, phase1_impl=None) -> MapAction:
    """ELARE (Algorithms 1-3): min-energy-feasible x min-value x proactive
    drops. ``phase1_impl`` plugs in a Phase-I implementation (the
    ``phase1_map`` kernel's wrapper, for one)."""
    pol = policy.ELARE
    if phase1_impl is not None:
        pol = pol.with_phase1_impl(phase1_impl)
    return pol(now, pending, task_type, deadline, view, sysarr, suffered)


def felare_select(now, pending, task_type, deadline, view, sysarr, suffered,
                  *, phase1_impl=None) -> MapAction:
    """FELARE (Sec. V) = ``with_fairness(ELARE)``."""
    pol = policy.FELARE
    if phase1_impl is not None:
        pol = pol.with_phase1_impl(phase1_impl)
    return pol(now, pending, task_type, deadline, view, sysarr, suffered)


mm_select = policy.MM
msd_select = policy.MSD
mmu_select = policy.MMU
met_select = policy.MET
mct_select = policy.MCT
random_select = policy.RANDOM


def elare_phase1(now, pending, task_type, deadline, view, sysarr, qfree,
                 phase1_impl=None):
    """Legacy Phase-I entry point.

    Returns ``(best_machine (B, N), best_ec (B, N), task_feasible (B, N),
    s, e)`` with ``s`` and ``e`` the (B, N, M) start and execution grids;
    a thin wrapper over the
    :class:`~repro_torch.core.policy.MinEnergyFeasible` nominator.
    """
    S = sysarr.eet.shape[-2]
    ctx = SchedContext(now, pending, task_type, deadline, view, sysarr,
                       torch.zeros((pending.shape[0], S), dtype=torch.bool,
                                   device=pending.device)).with_qfree(qfree)
    nom = policy.MinEnergyFeasible(impl=phase1_impl).nominate(ctx)
    return nom.best_machine, nom.value, nom.valid, ctx.start_grid, ctx.exec_grid
