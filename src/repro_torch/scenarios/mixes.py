"""Task-type mixes (counterpart of ``repro/scenarios/mixes.py``).

``sample(rng, n_tasks, n_types)`` returns ``(N,)`` int64 type indices in
``[0, n_types)``. A mix never sees arrival times: a drifting mix keys off
the arrival index, which is rate-free, so the common-random-number grid
draws the same types at every rate. The weighted and drift mixes are a
draw (uniform and Gumbel numbers) and a transform (the reference's
inverse-CDF search and Gumbel argmax).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np

from repro_torch.scenarios.base import component

F32 = np.float32


def _check_len(kind: str, probs: tuple, n_types: int) -> None:
    if len(probs) != n_types:
        raise ValueError(f"{kind} has {len(probs)} probs but the system has "
                         f"{n_types} task types")


@component("mix")
@dataclasses.dataclass(frozen=True)
class UniformMix:
    """Uniform over the task types (the paper's Sec. VI-A workload)."""

    kind: ClassVar[str] = "uniform"

    def sample(self, rng: np.random.Generator, n_tasks: int,
               n_types: int) -> np.ndarray:
        return rng.integers(0, n_types, n_tasks, dtype=np.int64)


@component("mix")
@dataclasses.dataclass(frozen=True)
class WeightedMix:
    """Fixed categorical type mix (``probs`` need not be normalized)."""

    kind: ClassVar[str] = "weighted"
    probs: Tuple[float, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "probs", tuple(float(p) for p in self.probs))
        if not self.probs:
            raise ValueError("WeightedMix needs a non-empty probs tuple")
        if any(p < 0 for p in self.probs) or sum(self.probs) <= 0:
            raise ValueError(f"probs must be non-negative and sum > 0, "
                             f"got {self.probs}")

    def transform(self, u) -> np.ndarray:
        """Inverse CDF of uniforms ``u`` in [0, 1): the first type whose
        float32 cumulative weight reaches ``total * (1 - u)``."""
        cum = np.cumsum(np.asarray(self.probs, F32), dtype=F32)
        r = cum[-1] * (F32(1) - np.asarray(u, F32))
        return np.searchsorted(cum, r).astype(np.int64)

    def sample(self, rng: np.random.Generator, n_tasks: int,
               n_types: int) -> np.ndarray:
        _check_len("WeightedMix", self.probs, n_types)
        return self.transform(rng.random(n_tasks, dtype=F32))


@component("mix")
@dataclasses.dataclass(frozen=True)
class DriftMix:
    """Time-varying mix: drifts linearly from ``start`` to ``end`` probs.

    Task ``k`` of ``N`` draws from ``(1 - w_k) start + w_k end`` with
    ``w_k = k / (N - 1)``, sampled as the argmax of the log-probabilities
    plus Gumbel noise over an (N, S) grid.
    """

    kind: ClassVar[str] = "drift"
    start: Tuple[float, ...] = ()
    end: Tuple[float, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "start", tuple(float(p) for p in self.start))
        object.__setattr__(self, "end", tuple(float(p) for p in self.end))
        for name, probs in (("start", self.start), ("end", self.end)):
            if not probs or any(p < 0 for p in probs) or sum(probs) <= 0:
                raise ValueError(f"DriftMix.{name} must be non-empty, "
                                 f"non-negative, sum > 0; got {probs}")
        if len(self.start) != len(self.end):
            raise ValueError("DriftMix start/end must have equal lengths")

    def probs(self, n_tasks: int) -> np.ndarray:
        """The (N, S) float32 grid of per-task type probabilities, formed as
        the reference forms it: ``jnp.linspace``'s weights (``k`` times the
        float32 reciprocal of ``N - 1``, the last one 1), each end
        normalized by its left-to-right sum."""
        p0 = np.asarray(self.start, F32)
        p0 = p0 / np.cumsum(p0, dtype=F32)[-1]
        p1 = np.asarray(self.end, F32)
        p1 = p1 / np.cumsum(p1, dtype=F32)[-1]
        if n_tasks > 1:
            w = np.arange(n_tasks, dtype=F32) * (F32(1) / F32(n_tasks - 1))
            w[-1] = 1
        else:
            w = np.zeros(n_tasks, F32)
        w = w[:, None]
        return (F32(1) - w) * p0 + w * p1

    def transform(self, gumbel) -> np.ndarray:
        """The argmax over types of ``gumbel + log(probs)`` (first on ties);
        ``gumbel`` is (N, S). numpy's float32 log may differ from XLA's in
        its last place, which can move the argmax only on a tie within
        one ulp."""
        g = np.asarray(gumbel, F32)
        with np.errstate(divide="ignore"):
            logits = np.log(self.probs(g.shape[0]))
        return np.argmax(g + logits, axis=-1).astype(np.int64)

    def sample(self, rng: np.random.Generator, n_tasks: int,
               n_types: int) -> np.ndarray:
        _check_len("DriftMix", self.start, n_types)
        return self.transform(rng.gumbel(size=(n_tasks, n_types)))


def mix_from_probs(type_probs: Optional[Tuple[float, ...]]):
    """``None`` -> :class:`UniformMix`, else :class:`WeightedMix`: the
    ``type_probs=`` shorthand as a mix component."""
    if type_probs is None:
        return UniformMix()
    return WeightedMix(tuple(float(p) for p in type_probs))
