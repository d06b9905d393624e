"""Runtime models (counterpart of ``repro/scenarios/runtimes.py``).

``sample(rng, eet, task_type, cv_run)`` returns ``(N, M)`` float32 actual
runtimes whose row means track ``eet[task_type]``. ``cv_run`` is the
sweep-level CV; models with their own dispersion ignore it. The per-type
Gamma and the lognormal models are a draw (standard Gamma or normal
numbers) and a transform in the reference's float32 arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np

from repro_torch.core import eet as eet_mod
from repro_torch.core.equations import exp32
from repro_torch.scenarios.base import component

F32 = np.float32


@component("runtime")
@dataclasses.dataclass(frozen=True)
class GammaRuntimes:
    """Gamma-distributed runtimes around the EET (the paper's model).

    ``cv=None`` takes the sweep-level ``cv_run``. ``cv_by_type`` instead
    gives each task type its own CV; it overrides both.
    """

    kind: ClassVar[str] = "gamma"
    cv: Optional[float] = None
    cv_by_type: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.cv_by_type is not None:
            object.__setattr__(self, "cv_by_type",
                               tuple(float(c) for c in self.cv_by_type))
            if any(c <= 0 for c in self.cv_by_type):
                raise ValueError("cv_by_type entries must be positive")
        if self.cv is not None and not self.cv > 0:
            raise ValueError("cv must be positive")

    def _type_cv(self, eet, task_type) -> np.ndarray:
        """(N, 1) float32 CV of each task's type."""
        cvs = np.asarray(self.cv_by_type, F32)
        if cvs.shape[0] != np.shape(eet)[0]:
            raise ValueError(f"cv_by_type has {cvs.shape[0]} entries but the "
                             f"system has {np.shape(eet)[0]} task types")
        return cvs[np.asarray(task_type)][:, None]

    def transform(self, draw, eet, task_type) -> np.ndarray:
        """Standard Gamma draws of shape ``1 / cv^2`` (per type) scaled to
        mean ``eet[task_type]``: ``draw * (means * cv^2)``."""
        cv_k = self._type_cv(eet, task_type)
        means = np.asarray(eet, F32)[np.asarray(task_type)]
        return (np.asarray(draw, F32) * (means * (cv_k * cv_k))).astype(F32)

    def sample(self, rng: np.random.Generator, eet, task_type,
               cv_run: float) -> np.ndarray:
        if self.cv_by_type is None:
            cv = self.cv if self.cv is not None else cv_run
            return eet_mod.sample_actual_exec(rng, eet, task_type, cv)
        cv_k = self._type_cv(eet, task_type)
        shape = np.broadcast_to(F32(1) / (cv_k * cv_k),
                                (len(task_type), np.shape(eet)[1]))
        draw = rng.standard_gamma(shape, dtype=F32)
        return self.transform(draw, eet, task_type)


@component("runtime")
@dataclasses.dataclass(frozen=True)
class LognormalRuntimes:
    """Heavy-tailed lognormal runtimes, mean-preserving around the EET.

    ``X = EET exp(sigma Z - sigma^2 / 2)`` with ``Z ~ N(0, 1)``: E[X] = EET,
    with a right tail far heavier than the Gamma model's.
    """

    kind: ClassVar[str] = "lognormal"
    sigma: float = 0.6

    def __post_init__(self):
        if not self.sigma > 0:
            raise ValueError("sigma must be positive")

    def transform(self, z, eet, task_type) -> np.ndarray:
        """``means * exp(sigma z - sigma^2 / 2)`` in float32, the
        exponential as the reference's compiled code computes it."""
        means = np.asarray(eet, F32)[np.asarray(task_type)]
        arg = F32(self.sigma) * np.asarray(z, F32) - F32(0.5 * self.sigma**2)
        return (means * exp32(arg)).astype(F32)

    def sample(self, rng: np.random.Generator, eet, task_type,
               cv_run: float) -> np.ndarray:
        del cv_run  # dispersion is governed by sigma
        z = rng.standard_normal((len(task_type), np.shape(eet)[1]), dtype=F32)
        return self.transform(z, eet, task_type)
