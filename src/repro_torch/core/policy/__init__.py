"""Composable scheduling-policy API, batched (counterpart of
``repro/core/policy``).

    Policy = Nominator (Phase I) x Phase2Key (Phase II) x DropRule
             [x with_fairness  (Sec. V suffered-type priority + eviction)]

The eight paper heuristics are registered by name. ``with_fused_phase1``
puts ELARE's Phase I on the ``phase1_map`` kernel, and
``with_fused_map`` runs the whole map decision through the
``map_fused`` kernels (the counterparts of the JAX package's
``with_pallas_phase1`` and ``with_pallas_map``).
"""
from __future__ import annotations

from repro_torch.core.policy.base import (
    DropRule,
    Nomination,
    Nominator,
    Phase2Key,
    PolicyDesc,
    TwoPhasePolicy,
    finalize,
    phase2,
)
from repro_torch.core.policy.components import (
    DropStale,
    DropStaleAndHopeless,
    Fcfs,
    MaxUrgency,
    MinCompletion,
    MinEnergyFeasible,
    MinExecution,
    NominationValue,
    RandomMachine,
    SoonestDeadline,
)
from repro_torch.core.policy.context import (
    BIG,
    MachineView,
    SchedContext,
    avail_time,
    queued_eet,
)
from repro_torch.core.policy.fair import FairnessPolicy, with_fairness
from repro_torch.core.policy.fused import FusedMapPolicy, supports_fused_map
from repro_torch.core.policy.registry import (
    get,
    is_registered,
    list_policies,
    register,
    unregister,
)

__all__ = [
    "BIG",
    "DropRule",
    "DropStale",
    "DropStaleAndHopeless",
    "FairnessPolicy",
    "Fcfs",
    "FusedMapPolicy",
    "MachineView",
    "MaxUrgency",
    "MinCompletion",
    "MinEnergyFeasible",
    "MinExecution",
    "Nomination",
    "Nominator",
    "NominationValue",
    "Phase2Key",
    "PolicyDesc",
    "RandomMachine",
    "SchedContext",
    "SoonestDeadline",
    "TwoPhasePolicy",
    "avail_time",
    "describe",
    "finalize",
    "get",
    "is_registered",
    "list_policies",
    "phase2",
    "queued_eet",
    "register",
    "supports_fused_map",
    "unregister",
    "with_fairness",
    "with_fused_map",
    "with_fused_phase1",
]


def describe(name_or_policy) -> PolicyDesc:
    """The declarative (nominator, key, drop, fairness) description."""
    pol = (get(name_or_policy) if isinstance(name_or_policy, str)
           else name_or_policy)
    fn = getattr(pol, "describe", None)
    if fn is None:
        raise TypeError(f"policy {pol!r} is opaque (no .describe())")
    return fn()


def with_fused_phase1(pol):
    """Put a policy's Phase I on the ``phase1_map`` kernel.

    No-op for policies whose nominator has no implementation hook (the
    built-ins: all but ELARE and FELARE).
    """
    if isinstance(pol, str):
        pol = get(pol)
    if not getattr(pol, "supports_phase1_impl", False):
        return pol
    from repro_torch.kernels.phase1_map.ops import phase1_map

    return pol.with_phase1_impl(phase1_map)


def with_fused_map(pol):
    """Run a policy's whole map decision through the ``map_fused`` kernels.

    No-op for policies outside the kernel's kind space or without a
    ``describe()``. A ``with_backup`` policy keeps its wrapper outermost
    (the engine reads ``backup_k`` off it) around a fused base.
    """
    import dataclasses

    from repro_torch.core.faults.backup import BackupPolicy

    if isinstance(pol, str):
        pol = get(pol)
    if isinstance(pol, BackupPolicy):
        return dataclasses.replace(pol, base=with_fused_map(pol.base))
    fn = getattr(pol, "describe", None)
    if fn is None or not supports_fused_map(fn()):
        return pol
    return FusedMapPolicy(pol)


# --------------------------------------------------------------------------
# The eight paper heuristics as compositions (Secs. IV-VI).
# --------------------------------------------------------------------------
ELARE = TwoPhasePolicy(MinEnergyFeasible(), NominationValue(),
                       DropStaleAndHopeless())
FELARE = with_fairness(ELARE)
MM = TwoPhasePolicy(MinCompletion(), NominationValue(), DropStale())
MSD = TwoPhasePolicy(MinCompletion(), SoonestDeadline(), DropStale())
MMU = TwoPhasePolicy(MinCompletion(), MaxUrgency(), DropStale())
MET = TwoPhasePolicy(MinExecution(), NominationValue(), DropStale())
MCT = TwoPhasePolicy(MinCompletion(), Fcfs(), DropStale())
RANDOM = TwoPhasePolicy(RandomMachine(), Fcfs(), DropStale())

for _name, _pol in [
    ("ELARE", ELARE), ("FELARE", FELARE), ("MM", MM), ("MSD", MSD),
    ("MMU", MMU), ("MET", MET), ("MCT", MCT), ("RANDOM", RANDOM),
]:
    register(_name, _pol)
del _name, _pol
