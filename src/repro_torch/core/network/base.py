"""Network-model protocol (counterpart of ``repro/core/network/base.py``).

A :class:`NetworkModel` describes the edge-cloud hierarchy the fleet
lives in: what each dispatch from a task's origin site to the site that
serves it costs in transfer latency and transfer energy. Models are
frozen, hashable dataclasses and pure data: ``cost_tables`` returns
host-side numpy float32 constants, which the engine gathers into
per-task link costs once per simulation.

Semantics (the reference's): each task originates at a device-tier site
(the lowest tier present in the fleet), chosen by a salted counter hash
of its index. When the dispatch stage routes it to site ``s``, the link
``origin -> s`` pushes its ready time at ``s`` to ``now + lat[type,
origin, s]`` (the mapper cannot place it before it lands) and charges
``en[type, origin, s]`` joules to the dynamic-energy account, tallied
per destination tier. Same-site dispatch is free: the diagonals are
exactly zero.
"""
from __future__ import annotations

from typing import Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

#: The multiplier of the origin hash (the ``sticky`` dispatcher's).
_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF


@runtime_checkable
class NetworkModel(Protocol):
    """Static description of inter-site transfer costs.

    Implementations are hashable (frozen dataclasses); ``kind`` names the
    model in registries and JSON payloads.
    """

    kind: str

    def cost_tables(self, tier_of_site: Sequence[int],
                    n_types: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(lat, en)``, each ``(n_types, F, F)`` float32:
        ``lat[t, o, s]`` / ``en[t, o, s]`` price a type-``t`` task
        dispatched from origin site ``o`` to site ``s``; zero diagonals."""
        ...


def origin_sites(tier_of_site: Sequence[int]) -> Tuple[int, ...]:
    """Sites eligible to originate tasks: every site on the lowest tier
    present (on an untiered fleet, every site)."""
    tiers = tuple(int(t) for t in tier_of_site)
    lo = min(tiers)
    return tuple(i for i, t in enumerate(tiers) if t == lo)


def hash_origins(n_tasks: int, eligible: Sequence[int], salt: int = 0,
                 device=None) -> torch.Tensor:
    """(N,) int64 origin site of each task on ``device``:
    ``eligible[(k * 2654435761 + salt) mod 2**32 mod len(eligible)]``,
    the reference's uint32 hash done in int64 masked to 32 bits. It
    depends on the task index alone, so every replicate of a batch shares
    it."""
    elig = torch.as_tensor(tuple(int(s) for s in eligible),
                           dtype=torch.int64, device=device)
    k = torch.arange(n_tasks, dtype=torch.int64, device=device)
    h = (((k * _HASH_MUL) & _U32) + (int(salt) & _U32)) & _U32
    return elig[h % elig.shape[0]]


def hash_origins_host(n_tasks: int, eligible: Sequence[int],
                      salt: int = 0) -> np.ndarray:
    """Host mirror of :func:`hash_origins`, (N,) int32."""
    elig = np.asarray(tuple(int(s) for s in eligible), dtype=np.int32)
    k = np.arange(n_tasks, dtype=np.uint64)
    h = ((k * _HASH_MUL + (int(salt) & _U32)) & _U32) % elig.shape[0]
    return elig[h.astype(np.int64)]
