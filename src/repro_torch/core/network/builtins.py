"""Built-in network models: ``none``, ``uniform_latency``, ``tiered``
(counterpart of ``repro/core/network/builtins.py``).

Frozen dataclasses with the reference's fields and validation, whose
``cost_tables`` compute the reference's float32 tables op for op (the
per-tier-pair gather, the per-type ``input_size`` scaling, the zeroed
diagonal), so both packages price every link with the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def _zero_diag(lat: np.ndarray, en: np.ndarray) -> None:
    idx = np.arange(lat.shape[1])
    lat[:, idx, idx] = 0.0
    en[:, idx, idx] = 0.0


@dataclasses.dataclass(frozen=True)
class NoNetwork:
    """Free, instantaneous links everywhere (the network-free federation).

    The engine turns it into no network at all: no transfer arithmetic
    enters the loop.
    """

    kind = "none"

    def cost_tables(self, tier_of_site: Sequence[int],
                    n_types: int) -> Tuple[np.ndarray, np.ndarray]:
        f = len(tuple(tier_of_site))
        z = np.zeros((n_types, f, f), dtype=np.float32)
        return z, z.copy()


@dataclasses.dataclass(frozen=True)
class UniformLatency:
    """Flat mesh: every cross-site hop costs the same, same-site is free.

    One latency and one energy figure for any off-site dispatch,
    independent of task type and tier.
    """

    kind = "uniform_latency"

    latency: float = 0.25
    energy: float = 0.0
    salt: int = 0

    def __post_init__(self):
        if float(self.latency) < 0.0 or float(self.energy) < 0.0:
            raise ValueError("uniform_latency costs must be >= 0")

    def cost_tables(self, tier_of_site: Sequence[int],
                    n_types: int) -> Tuple[np.ndarray, np.ndarray]:
        f = len(tuple(tier_of_site))
        lat = np.full((n_types, f, f), np.float32(self.latency),
                      dtype=np.float32)
        en = np.full((n_types, f, f), np.float32(self.energy),
                     dtype=np.float32)
        _zero_diag(lat, en)
        return lat, en


#: Default per-tier-pair link latency (seconds per unit input size).
_DEFAULT_LATENCY = ((0.05, 0.2, 1.0),
                    (0.2, 0.05, 0.5),
                    (1.0, 0.5, 0.0))
#: Default per-tier-pair transfer energy (joules per unit input size).
_DEFAULT_ENERGY = ((0.1, 0.5, 2.0),
                   (0.5, 0.1, 1.0),
                   (2.0, 1.0, 0.0))


@dataclasses.dataclass(frozen=True)
class Tiered:
    """Per-tier-pair latency/energy matrix scaled by task input size.

    ``latency[i][j]`` / ``energy[i][j]`` price a transfer from a tier-i
    origin to a tier-j destination, per unit of input size;
    ``input_size[t]`` scales both for task type ``t`` (empty: every type
    moves one unit). Same-site transfers are free; distinct sites on one
    tier pay the intra-tier entry.
    """

    kind = "tiered"

    latency: Tuple[Tuple[float, ...], ...] = _DEFAULT_LATENCY
    energy: Tuple[Tuple[float, ...], ...] = _DEFAULT_ENERGY
    input_size: Tuple[float, ...] = ()
    salt: int = 0

    def __post_init__(self):
        lat = tuple(tuple(float(x) for x in row) for row in self.latency)
        en = tuple(tuple(float(x) for x in row) for row in self.energy)
        object.__setattr__(self, "latency", lat)
        object.__setattr__(self, "energy", en)
        object.__setattr__(self, "input_size",
                           tuple(float(x) for x in self.input_size))
        for name, m in (("latency", lat), ("energy", en)):
            if not m or any(len(row) != len(m) for row in m):
                raise ValueError(f"tiered {name} matrix must be square")
            if any(x < 0.0 for row in m for x in row):
                raise ValueError(f"tiered {name} entries must be >= 0")
        if len(lat) != len(en):
            raise ValueError("latency and energy matrices must agree in size")
        if any(s < 0.0 for s in self.input_size):
            raise ValueError("input_size entries must be >= 0")

    def cost_tables(self, tier_of_site: Sequence[int],
                    n_types: int) -> Tuple[np.ndarray, np.ndarray]:
        tiers = tuple(int(t) for t in tier_of_site)
        n_tiers = len(self.latency)
        if tiers and max(tiers) >= n_tiers:
            raise ValueError(
                f"fleet uses tier {max(tiers)} but the tiered matrix only "
                f"covers tiers 0..{n_tiers - 1}")
        if self.input_size and len(self.input_size) != n_types:
            raise ValueError(
                f"input_size has {len(self.input_size)} entries for "
                f"{n_types} task types")
        size = (np.asarray(self.input_size, dtype=np.float32)
                if self.input_size
                else np.ones((n_types,), dtype=np.float32))
        t = np.asarray(tiers, dtype=np.int32)
        # cost[t, o, s] = size[t] * M[tier[o], tier[s]], in float32
        lat_ff = np.asarray(self.latency, dtype=np.float32)[
            t[:, None], t[None, :]]
        en_ff = np.asarray(self.energy, dtype=np.float32)[
            t[:, None], t[None, :]]
        lat = (size[:, None, None] * lat_ff[None, :, :]).astype(np.float32)
        en = (size[:, None, None] * en_ff[None, :, :]).astype(np.float32)
        _zero_diag(lat, en)
        return lat, en
