"""Built-in dispatchers (counterpart of ``repro/core/dispatch/builtins.py``).

Each is a frozen (hashable) dataclass carrying the same ``kind`` and
fields as its JAX twin. All are dispatch-once: a task's site is chosen
the first time it is pending and never migrates (an orphan of a dead
machine is dispatched anew).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core.dispatch.base import DispatchContext, sequential_balance


@functools.lru_cache(maxsize=32)
def _hash_sites(batch: int, n_tasks: int, n_sites: int, salt: int,
                device: torch.device) -> torch.Tensor:
    """(B, N) int64 static multiplicative-hash home sites,
    ``(k * 2654435761 + salt) % F`` with uint32 wrap-around (computed in
    int64 and masked to 32 bits). Static per simulator, so built once."""
    mask = 0xFFFFFFFF
    k = torch.arange(n_tasks, dtype=torch.int64, device=device)
    h = (((k * 2654435761) & mask) + (salt & mask)) & mask
    return (h % n_sites).expand(batch, n_tasks).contiguous()


def _homes(ctx: DispatchContext, salt: int) -> torch.Tensor:
    B, N = ctx.unassigned.shape
    return _hash_sites(B, N, ctx.n_sites, int(salt), ctx.unassigned.device)


def _fastest_site(ctx: DispatchContext) -> torch.Tensor:
    """Each task's site with the fastest machine for its type (lowest
    site on ties), from the shared (S, F) minima or per replicate from
    health-masked (B, S, F) ones."""
    best = ctx.eet_min_by_site.argmin(dim=-1)         # (S,) or (B, S)
    if best.dim() == 1:
        return best[ctx.task_type]
    return best.gather(1, ctx.task_type)


def _task_site_minima(ctx: DispatchContext) -> torch.Tensor:
    """(B, N, F) each task's fastest EET per site, gathered from the
    shared (S, F) minima or per replicate from (B, S, F) ones."""
    ems = ctx.eet_min_by_site
    if ems.dim() == 2:
        return ems[ctx.task_type]
    B, N = ctx.task_type.shape
    idx = ctx.task_type[:, :, None].expand(B, N, ems.shape[2])
    return ems.gather(1, idx)


@dataclasses.dataclass(frozen=True)
class Sticky:
    """Load-blind home site, fixed at admission.

    Default: a multiplicative hash of the task index. With
    ``by_type=True`` the home is ``task_type % F`` instead (type-to-site
    affinity).
    """

    kind = "sticky"
    salt: int = 0
    by_type: bool = False

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        if self.by_type:
            return ctx.task_type % ctx.n_sites
        return _homes(ctx, self.salt)


@dataclasses.dataclass(frozen=True)
class RoundRobin:
    """Arrival-order round-robin: task index mod F."""

    kind = "round_robin"

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        return torch.arange(ctx.n_tasks, device=ctx.unassigned.device) \
            % ctx.n_sites


@dataclasses.dataclass(frozen=True)
class LeastQueued:
    """Join-the-shortest-site: least queued+running tasks at dispatch time.

    Simultaneous admissions are balanced sequentially in arrival order,
    so a burst spreads across sites. ``balance_impl`` optionally swaps
    the balance walk onto the ``balance_scan`` kernel (via
    ``with_fused_balance``)."""

    kind = "least_queued"
    balance_impl: Optional[Callable] = None

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        all_spill = torch.ones_like(ctx.unassigned)
        home = torch.zeros_like(ctx.task_type)
        return sequential_balance(ctx, all_spill, home, self.balance_impl)


@dataclasses.dataclass(frozen=True)
class MinEet:
    """EET-aware cheapest site: the site whose fastest machine for the
    task's type has the smallest expected execution time (ties -> lowest
    site id). Load-blind."""

    kind = "min_eet"

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        return _fastest_site(ctx)


@dataclasses.dataclass(frozen=True)
class FairSpill:
    """Sticky homes, but *suffered* types may spill to the least-loaded
    site — FELARE's Alg. 4 fairness signal reused at the dispatch level."""

    kind = "fair_spill"
    salt: int = 0
    balance_impl: Optional[Callable] = None

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        spill = ctx.suffered.gather(1, ctx.task_type)
        return sequential_balance(ctx, spill, _homes(ctx, self.salt),
                                  self.balance_impl)


@dataclasses.dataclass(frozen=True)
class TierAware:
    """EET-aware cheapest site including the cost of getting there.

    Scores each site by the EET of its fastest machine for the task's
    type plus the transfer latency from the task's origin (one float32
    add) and takes the argmin, lowest site on ties. With no network
    attached (``ctx.xfer_lat is None``) the latency term vanishes and
    this is ``min_eet``, bit for bit."""

    kind = "tier_aware"

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        if ctx.xfer_lat is None:
            return _fastest_site(ctx)
        return (_task_site_minima(ctx) + ctx.xfer_lat).argmin(dim=-1)


@dataclasses.dataclass(frozen=True)
class HealthAware:
    """Sticky homes, but tasks whose home site is down re-route to the
    least-loaded healthy site.

    Reads the heartbeat mask ``ctx.site_alive`` (a site is alive iff it
    has a healthy machine). Healthy-home tasks keep their hash home; with
    no dynamics attached the mask is absent and this is ``sticky``, bit
    for bit. Dead-home tasks enter the ``sequential_balance`` walk (on
    the ``balance_scan`` kernel with ``with_fused_balance``), where dead
    sites carry a load penalty, so re-routed work spreads over the
    surviving sites."""

    kind = "health_aware"
    salt: int = 0
    balance_impl: Optional[Callable] = None

    def dispatch(self, ctx: DispatchContext) -> torch.Tensor:
        home = _homes(ctx, self.salt)
        if ctx.site_alive is None:
            return home
        reroute = ~ctx.site_alive.gather(1, home)
        return sequential_balance(ctx, reroute, home, self.balance_impl)
