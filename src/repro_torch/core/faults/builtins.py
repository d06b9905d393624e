"""Built-in machine dynamics, batched (counterpart of
``repro/core/faults/builtins.py``).

Each is a frozen (hashable) dataclass with the same ``kind`` and fields
as its JAX twin, and each ``step`` mirrors the reference op for op on
(B, M) tensors: float32 thresholds and window edges, and the
integer-exact :func:`~repro_torch.core.faults.base.hash_uniform` draws.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.faults.base import FaultContext, hash_uniform


def _f32(x: float) -> torch.Tensor:
    """``float32(x)`` as a 0-dim CPU tensor: it enters an op on the card as
    a scalar, with no copy to the device."""
    return torch.tensor(x, dtype=torch.float32)


@functools.lru_cache(maxsize=32)
def _site_ids(site_of_machine: tuple, device) -> torch.Tensor:
    """(M,) int64 partition on ``device``, copied there once."""
    return torch.as_tensor(site_of_machine, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=32)
def _degraded(dyn: "Degrade", n_machines: int, device) -> torch.Tensor:
    """(M,) f32 slowdown of a :class:`Degrade`: static over a trace, so it
    is built once per machine count and device."""
    machine = torch.arange(n_machines, device=device)
    if dyn.machines is not None:
        straggler = torch.zeros(n_machines, dtype=torch.bool, device=device)
        straggler[list(dyn.machines)] = True
    else:
        u = hash_uniform(machine, torch.zeros((), dtype=torch.int64,
                                              device=device), dyn.seed)
        straggler = u < _f32(dyn.p)
    return torch.where(straggler, float(dyn.factor), 1.0)


@dataclasses.dataclass(frozen=True)
class NoDynamics:
    """No failures: every machine healthy forever (the default).

    The engine treats this as the absence of a dynamics: the ``faults``
    stage is skipped and no health masking enters the loop, so
    ``dynamics="none"`` runs exactly the loop without faults.
    """

    kind = "none"
    max_retries: int = 3

    def step(self, ctx: FaultContext):
        return ctx.alive, ctx.slowdown

    def wake_fracs(self) -> Tuple[float, ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class BernoulliUpDown:
    """Independent per-machine fail/recover Markov chain, one draw per event.

    At each event every machine draws one :func:`hash_uniform` value
    keyed on ``(machine, event counter, seed)``: an alive machine dies
    with probability ``p_fail``, a dead one recovers with probability
    ``p_recover``. Each replicate draws at its own event counter.
    """

    kind = "bernoulli_updown"
    p_fail: float = 0.02
    p_recover: float = 0.2
    seed: int = 0
    max_retries: int = 3

    def step(self, ctx: FaultContext):
        machine = torch.arange(ctx.n_machines, device=ctx.alive.device)
        u = hash_uniform(machine, ctx.steps[:, None], self.seed)
        alive = torch.where(ctx.alive, u >= _f32(self.p_fail),
                            u < _f32(self.p_recover))
        return alive, ctx.slowdown

    def wake_fracs(self) -> Tuple[float, ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class SiteOutage:
    """Scheduled correlated whole-site outages (power loss, backhaul cut).

    ``outages`` is a tuple of ``(site, start_frac, end_frac)`` windows,
    fractions of each trace's horizon (max deadline): every machine of
    ``site`` is dead for ``now in [float32(start_frac) * horizon,
    float32(end_frac) * horizon)`` and healthy outside all of its
    windows. The window edges are :meth:`wake_fracs`, so the engine fires
    an event at each of them.
    """

    kind = "site_outage"
    outages: Tuple[Tuple[int, float, float], ...] = ((0, 0.25, 0.5),)
    max_retries: int = 3

    def __post_init__(self):
        norm = tuple((int(s), float(a), float(b))
                     for (s, a, b) in self.outages)
        for s, a, b in norm:
            if not (0.0 <= a < b):
                raise ValueError(
                    f"outage window ({s}, {a}, {b}) needs 0 <= start < end")
        object.__setattr__(self, "outages", norm)

    def step(self, ctx: FaultContext):
        site_ids = _site_ids(tuple(ctx.site_of_machine), ctx.alive.device)
        now = ctx.now[:, None]
        dead = torch.zeros_like(ctx.alive)
        for s, a, b in self.outages:
            t0 = (_f32(a) * ctx.horizon)[:, None]
            t1 = (_f32(b) * ctx.horizon)[:, None]
            dead = dead | ((site_ids == s) & (now >= t0) & (now < t1))
        return ~dead, ctx.slowdown

    def wake_fracs(self) -> Tuple[float, ...]:
        return tuple(sorted({float(f) for (_, a, b) in self.outages
                             for f in (a, b)}))


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Stragglers: a static set of machines runs slower, nothing dies.

    The straggler set is either ``machines`` (explicit indices) or, when
    ``None``, each machine independently with probability ``p`` (one
    :func:`hash_uniform` draw keyed on ``(machine, 0, seed)``). Stragglers
    execute every task ``factor`` times slower: the engine scales their
    EET column and their actual runtimes.
    """

    kind = "degrade"
    factor: float = 2.0
    machines: Optional[Tuple[int, ...]] = None
    p: float = 0.25
    seed: int = 0
    max_retries: int = 3

    def __post_init__(self):
        if self.machines is not None:
            object.__setattr__(self, "machines",
                               tuple(int(j) for j in self.machines))
        if self.factor <= 0:
            raise ValueError(f"factor must be positive, got {self.factor}")

    def step(self, ctx: FaultContext):
        slow = _degraded(self, ctx.n_machines, ctx.alive.device)
        return ctx.alive, slow.expand_as(ctx.slowdown)

    def wake_fracs(self) -> Tuple[float, ...]:
        return ()
