"""Task-type mixes (counterpart of ``repro/scenarios/mixes.py``); only
the paper's uniform mix is ported."""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np


@dataclasses.dataclass(frozen=True)
class UniformMix:
    """Uniform over the task types (the paper's Sec. VI-A workload)."""

    kind: ClassVar[str] = "uniform"

    def sample(self, rng: np.random.Generator, n_tasks: int,
               n_types: int) -> np.ndarray:
        return rng.integers(0, n_types, n_tasks, dtype=np.int64)
