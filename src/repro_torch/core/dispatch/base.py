"""The dispatch layer's typed surface: context + protocol, batched.

Counterpart of ``repro/core/dispatch/base.py``. A federation separates
*where a task goes* (which site) from *where it runs* (which machine of
that site). The first question is answered once per task, at the
engine's ``dispatch`` stage, by a :class:`Dispatcher`; the second stays
the per-site mapping policy's job, run under a site view.

:class:`DispatchContext` freezes everything a dispatcher may look at for
a batch of B replicates and caches each derived per-site aggregate. The
site partition and the site count are static: one (M,) partition for the
whole batch.

With a machine dynamics attached the engine hands the context the
replicates' health, ``alive`` (B, M), and an EET table masked by it, one
per replicate, (B, S, M): dead machines' columns read BIG and
stragglers' are slowdown-scaled. With a network attached it hands the
per-task link costs from each task's origin to every site, ``xfer_lat``
and ``xfer_energy``, (B, N, F).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Protocol

import torch

from repro_torch.core import fairness
from repro_torch.core.equations import BIG
from repro_torch.kernels.map_fused.ops import balance_scan_plain


def site_minima(eet: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """(S, F) each type's fastest EET within each site, from the (S, M)
    table and the (F, M) membership grid; (B, S, F) from per-replicate
    (B, S, M) tables."""
    big = torch.full((), BIG, device=eet.device)
    return torch.where(members, eet[..., None, :], big).amin(dim=-1)


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """Frozen snapshot of one batched dispatch event.

    Shapes: B replicates, N tasks, M machines, S types, F sites (static).
    """

    now: torch.Tensor          # (B,) f32 current event time
    unassigned: torch.Tensor   # (B, N) bool — pending and not yet dispatched
    task_type: torch.Tensor    # (B, N) int64
    deadline: torch.Tensor     # (B, N) f32
    qlen: torch.Tensor         # (B, M) int64 local-queue occupancy
    running: torch.Tensor      # (B, M) bool machine is executing a task
    completed: torch.Tensor    # (B, S) int64 on-time completions so far
    arrived: torch.Tensor      # (B, S) int64 arrivals so far
    eet: torch.Tensor          # (S, M) f32, or (B, S, M) health-masked
    site_of_machine: object    # (M,) int static partition (array or tensor)
    n_sites: int               # F, static
    fairness_factor: float     # Eq. 3's f, static engine config
    alive: Optional[torch.Tensor] = None        # (B, M) bool, None: no faults
    #: (B, N, F) f32 per-task transfer latency / energy to each site
    #: (``None``: no network, free links).
    xfer_lat: Optional[torch.Tensor] = None
    xfer_energy: Optional[torch.Tensor] = None
    #: (S, F) :attr:`eet_min_by_site`, when the caller already holds it
    #: (the engine computes it once per simulator: without faults it is
    #: static).
    eet_min_site: Optional[torch.Tensor] = None
    #: An upper bound on the new tasks of any replicate, known to the
    #: caller without reading the device; the plain balance walk loops to
    #: it. ``None`` lets the walk read it.
    max_new: Optional[int] = None

    # -- static shapes ------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return self.unassigned.shape[1]

    @property
    def n_machines(self) -> int:
        return self.qlen.shape[1]

    # -- static site structure ---------------------------------------------
    @functools.cached_property
    def site_ids(self) -> torch.Tensor:
        """(M,) int64 — the partition on the context's device."""
        return torch.as_tensor(self.site_of_machine, dtype=torch.int64,
                               device=self.qlen.device)

    @functools.cached_property
    def site_members(self) -> torch.Tensor:
        """(F, M) bool — the partition's membership grid."""
        f = torch.arange(self.n_sites, device=self.qlen.device)
        return f[:, None] == self.site_ids[None, :]

    # -- derived per-site load ---------------------------------------------
    def _per_site(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F) sums of a (B, M) int64 tensor over each site's machines."""
        B, M = x.shape
        return torch.zeros((B, self.n_sites), dtype=torch.int64,
                           device=x.device).scatter_add(
            1, self.site_ids.expand(B, M), x)

    @functools.cached_property
    def site_queued(self) -> torch.Tensor:
        """(B, F) int64 — queued tasks per site."""
        return self._per_site(self.qlen)

    @functools.cached_property
    def site_running(self) -> torch.Tensor:
        """(B, F) int64 — busy machines per site."""
        return self._per_site(self.running.to(torch.int64))

    @functools.cached_property
    def site_load(self) -> torch.Tensor:
        """(B, F) int64 — queued + running tasks per site (the load signal
        ``least_queued`` and ``fair_spill`` balance on)."""
        return self.site_queued + self.site_running

    # -- derived per-site EET structure ------------------------------------
    @functools.cached_property
    def eet_min_by_site(self) -> torch.Tensor:
        """(S, F) f32 — each type's fastest machine within each site;
        (B, S, F) from a health-masked table, where a site with no healthy
        machine reads BIG."""
        if self.eet_min_site is not None:
            return self.eet_min_site
        return site_minima(self.eet, self.site_members)

    # -- site health (faults subsystem) -------------------------------------
    @functools.cached_property
    def site_alive(self) -> Optional[torch.Tensor]:
        """(B, F) bool — heartbeat mask: a site is alive iff it has at
        least one healthy machine. ``None`` without machine dynamics."""
        if self.alive is None:
            return None
        return self._per_site(self.alive.to(torch.int64)) > 0

    # -- fairness monitor ---------------------------------------------------
    @functools.cached_property
    def suffered(self) -> torch.Tensor:
        """(B, S) bool — the Alg. 4 suffered-type mask at this event."""
        return fairness.suffered_types(self.completed, self.arrived,
                                       self.fairness_factor)


class Dispatcher(Protocol):
    """Site selection for newly-admitted tasks.

    Implementations are frozen (hashable) dataclasses with a ``kind``
    tag. ``dispatch`` returns a (B, N) (or (N,), shared by the batch)
    int64 site proposal for *every* task; the engine applies it only
    where ``ctx.unassigned`` is True, and a task's site never changes
    afterwards.
    """

    kind: str

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor: ...


def sequential_balance(ctx: DispatchContext, target_mask, home,
                       impl=None) -> torch.Tensor:
    """Shared least-loaded assignment walk (``least_queued``/``fair_spill``).

    Walks each replicate's tasks in index (arrival) order carrying
    per-site loads: each task whose ``target_mask`` (B, N) is set goes to
    the currently least-loaded site (ties -> lowest site id), others keep
    their ``home`` (B, N) proposal; every unassigned task increments its
    site's load, so simultaneous admissions spread instead of
    dog-piling one site. Integer arithmetic throughout.

    With machine dynamics (``ctx.site_alive`` is not None) dead sites
    enter the walk with a +1,000,000 load penalty, so the least-loaded
    choice never lands on a site without a healthy machine while any
    site is up.

    ``impl`` optionally replaces the plain walk with a fused
    implementation of the same contract (``impl(load0, unassigned,
    target_mask, home) -> (B, N) int64 sites``): the CUDA
    ``balance_scan`` kernel plugs in here via
    :func:`repro_torch.core.dispatch.with_fused_balance`.
    """
    load0 = ctx.site_load
    if ctx.site_alive is not None:
        load0 = load0 + torch.where(ctx.site_alive, 0, 1_000_000)
    if impl is not None:
        return impl(load0, ctx.unassigned, target_mask, home)
    return balance_scan_plain(load0, ctx.unassigned, target_mask, home,
                              max_new=ctx.max_new)
