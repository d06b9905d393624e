"""Core datatypes of the port (counterpart of ``repro/core/types.py``).

Shapes use the paper's notation: S task types, M machines, N tasks, Q
local-queue slots. The port adds an explicit leading batch dim B where
the JAX package relied on ``vmap``: every per-trace tensor below carries
it once it is inside the engine.

A ``SystemSpec`` may partition its machines into federation sites
(``site_of_machine``) and its sites into edge-cloud tiers
(``tier_of_site``); ``SimState`` carries each task's site, the health
fields of the faults subsystem when a machine dynamics is attached, and
the transfer fields of the network subsystem when a network is attached.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

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
    site_of_machine: optional (M,) partition of the machines into F
      federation sites, numbered ``0..F-1``, each owning at least one
      machine; ``None`` is the flat system (one site). Stored as a tuple.
    tier_of_site: optional (F,) edge-cloud tier of each site (device 0,
      edge 1, cloud 2); ``None`` puts every site on the device tier.
    """

    eet: np.ndarray
    p_dyn: np.ndarray
    p_idle: np.ndarray
    queue_size: int = 2
    fairness_factor: float = 1.0
    site_of_machine: Optional[Tuple[int, ...]] = None
    tier_of_site: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.site_of_machine is not None:
            sites = tuple(int(s) for s in np.asarray(self.site_of_machine))
            object.__setattr__(self, "site_of_machine", sites)
            if len(sites) != self.n_machines:
                raise ValueError(
                    f"site_of_machine has {len(sites)} entries for "
                    f"{self.n_machines} machines")
            n_sites = max(sites) + 1
            if min(sites) < 0 or set(sites) != set(range(n_sites)):
                raise ValueError(
                    f"sites must be contiguous 0..F-1 with every site "
                    f"non-empty, got {sites}")
        if self.tier_of_site is not None:
            tiers = tuple(int(t) for t in np.asarray(self.tier_of_site))
            object.__setattr__(self, "tier_of_site", tiers)
            if len(tiers) != self.n_sites:
                raise ValueError(f"tier_of_site has {len(tiers)} entries "
                                 f"for {self.n_sites} sites")
            if min(tiers) < 0:
                raise ValueError(f"tiers must be >= 0, got {tiers}")

    @property
    def n_task_types(self) -> int:
        return np.shape(self.eet)[0]

    @property
    def n_machines(self) -> int:
        return np.shape(self.eet)[1]

    @property
    def n_sites(self) -> int:
        """Number of federation sites F (1 for the flat system)."""
        return 1 if self.site_of_machine is None else \
            max(self.site_of_machine) + 1

    @property
    def sites(self) -> Tuple[int, ...]:
        """The (M,) site partition, materialized (all zeros when unset)."""
        if self.site_of_machine is None:
            return (0,) * self.n_machines
        return self.site_of_machine

    @property
    def tiers(self) -> Tuple[int, ...]:
        """The (F,) site tiers, materialized (all device when unset)."""
        if self.tier_of_site is None:
            return (0,) * self.n_sites
        return self.tier_of_site

    @property
    def n_tiers(self) -> int:
        """Number of hierarchy levels spanned (``max tier + 1``)."""
        return max(self.tiers) + 1

    def as_torch(self, device) -> "SystemArrays":
        """The float32 tensors the engine and the policies read."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return SystemArrays(eet=f32(self.eet), p_dyn=f32(self.p_dyn),
                            p_idle=f32(self.p_idle))


def site_membership(site_of_machine, n_sites: Optional[int] = None
                    ) -> np.ndarray:
    """(F, M) bool membership grid of a site partition: row ``s`` is the
    machine mask of site ``s``."""
    sites = np.asarray(site_of_machine, np.int64)
    F = int(sites.max()) + 1 if n_sites is None else int(n_sites)
    return np.arange(F)[:, None] == sites[None, :]


class SystemArrays(NamedTuple):
    """Device-side mirror of :class:`SystemSpec`.

    The engine's own arrays are shared by the batch: ``eet`` (S, M) and
    the powers (M,). A policy may also be handed one table per row,
    ``eet`` (B, S, M) and ``p_dyn`` (B, M): the engine does so for the
    federation's site views, where row ``b * F + f`` is site ``f`` of
    replicate ``b``.
    """

    eet: torch.Tensor     # (S, M) or (B, S, M) f32
    p_dyn: torch.Tensor   # (M,) or (B, M) f32
    p_idle: torch.Tensor  # (M,) or (B, M) f32


class Trace(NamedTuple):
    """A workload trace of N arrival-sorted tasks, or a stack of them.

    One trace has leaves (N,) and (N, M); a batch carries leading dims.
    """

    arrival: torch.Tensor      # (..., N) f32
    task_type: torch.Tensor    # (..., N) int32, as in the reference
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

    The health fields are ``None`` unless a machine dynamics is attached
    (:mod:`repro_torch.core.faults`), so the loop without one carries and
    freezes nothing for them; ``backup`` is ``None`` too unless the policy
    nominates backups (``with_backup``). Likewise ``ready`` and ``e_xfer``
    are ``None`` unless a network is attached (:mod:`repro_torch.core.
    network`).
    """

    now: torch.Tensor          # (B,) f32
    status: torch.Tensor       # (B, N) int64
    site: torch.Tensor         # (B, N) int64 federation site, -1 undispatched
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
    alive: Optional[torch.Tensor] = None     # (B, M) bool machine health
    slowdown: Optional[torch.Tensor] = None  # (B, M) f32 EET scale factors
    retries: Optional[torch.Tensor] = None   # (B, N) int64 orphan count
    backup: Optional[torch.Tensor] = None    # (B, N, k) int64, -1 = none
    ready: Optional[torch.Tensor] = None     # (B, N) f32 site ready time
    e_xfer: Optional[torch.Tensor] = None    # (B, T) f32 transfer J by tier


class EngineState(NamedTuple):
    """The event-loop carrier: core state + observer aux.

    ``aux`` maps each attached observer's name to its own fixed-shape
    tree of tensors, so extensions carry state through the loop without
    touching :class:`SimState` fields. With no observers it is an empty
    dict.
    """

    sim: SimState
    aux: dict  # observer name -> tree of tensors, fixed per simulation


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
