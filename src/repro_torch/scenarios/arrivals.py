"""Arrival processes (counterpart of ``repro/scenarios/arrivals.py``);
only the paper's stationary Poisson process is ported."""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Stationary Poisson arrivals (the paper's Sec. VI-A workload):
    Exp(1) gaps divided by the rate, accumulated in float32."""

    kind: ClassVar[str] = "poisson"

    def sample(self, rng: np.random.Generator, n_tasks: int,
               rate: float) -> np.ndarray:
        gaps = rng.standard_exponential(n_tasks, dtype=np.float32)
        return np.cumsum(gaps / np.float32(rate), dtype=np.float32)
