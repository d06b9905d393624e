"""The MachineDynamics protocol, batched (counterpart of
``repro/core/faults/base.py``).

A dynamics evolves a per-machine health state at the engine's ``faults``
stage:

  * :class:`FaultContext` — the frozen snapshot a dynamics reads: the
    current time, the event counter and the trace horizon of each of the
    B replicates, the health state it is evolving, and the static site
    partition;
  * :class:`MachineDynamics` — the protocol: frozen hashable dataclasses
    with a ``kind`` tag and a pure ``step(ctx) -> (alive, slowdown)``;
  * :func:`hash_uniform` — the counter-based uniform draw the stochastic
    built-ins key on, a pure function of ``(machine, event counter,
    seed)``, so every heuristic of a sweep sees the same failures and a
    plain-integer mirror (:func:`hash_uniform_host`) reproduces each
    draw exactly.

Health is two tensors in ``SimState``, present only with a dynamics:

  ``alive``    (B, M) bool — dead machines read avail=BIG/EET=BIG at the
               dispatch and map stages, like out-of-site machines;
  ``slowdown`` (B, M) f32  — a straggler factor scaling the machine's EET
               column and actual runtimes; 1.0 = nominal.

Each replicate keeps its own event counter, frozen once it is done, so
health differs across the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FaultContext:
    """Frozen snapshot handed to :meth:`MachineDynamics.step` each event.

    ``now``, ``steps`` and ``horizon`` are (B,) tensors, ``alive`` and
    ``slowdown`` (B, M); ``site_of_machine`` and ``n_sites`` are static.
    ``horizon`` is each trace's max deadline, the time scale window-based
    dynamics express their fractions against.
    """

    now: torch.Tensor          # (B,) f32 current event time
    steps: torch.Tensor        # (B,) int64 completed loop iterations
    horizon: torch.Tensor      # (B,) f32 trace horizon (max deadline)
    alive: torch.Tensor        # (B, M) bool current health
    slowdown: torch.Tensor     # (B, M) f32 current EET scale factors
    site_of_machine: tuple     # (M,) int — static partition
    n_sites: int               # F — static

    @property
    def n_machines(self) -> int:
        return self.alive.shape[1]


class MachineDynamics(Protocol):
    """A per-machine health process evolved at the engine's ``faults`` stage.

    ``step`` returns the next ``(alive, slowdown)`` pair, both (B, M), as
    pure functions of the context. ``wake_fracs`` names horizon
    fractions at which the engine must fire an event even if nothing
    else is due. ``max_retries`` bounds orphan re-dispatch: a task
    orphaned more often is CANCELLED.
    """

    kind: str
    max_retries: int

    def step(self, ctx: FaultContext) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    def wake_fracs(self) -> Tuple[float, ...]: ...


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``c`` below 2**32, with no intermediate past 2**48: the constant is
    split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_uniform(machine, steps, seed: int) -> torch.Tensor:
    """Counter-based uniform draw in [0, 1), exact in float32.

    The reference's multiplicative-xorshift hash of ``(machine, steps,
    seed)`` on wrapping uint32 arithmetic, done in int64 masked to 32
    bits. The top 24 bits become the value, so every draw is an exact
    float32. ``machine`` and ``steps`` are int64 tensors that broadcast.
    """
    x = (_mul32(machine & _M32, 0x9E3779B1)
         + _mul32(steps & _M32, 0x85EBCA6B)
         + ((seed & _M32) * 0xC2B2AE35 & _M32)) & _M32
    x = _mul32(x, 2654435761)
    x = x ^ (x >> 13)
    x = _mul32(x, 2654435761)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniform_host(machine: int, steps: int, seed: int) -> np.float32:
    """Plain-integer mirror of :func:`hash_uniform`."""
    x = (machine * 0x9E3779B1 + steps * 0x85EBCA6B
         + ((seed & _M32) * 0xC2B2AE35 & _M32)) & _M32
    x = (x * 2654435761) & _M32
    x ^= x >> 13
    x = (x * 2654435761) & _M32
    return np.float32(np.float32(x >> 8) * np.float32(1.0 / (1 << 24)))
