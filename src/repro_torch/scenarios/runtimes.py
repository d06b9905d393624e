"""Runtime models (counterpart of ``repro/scenarios/runtimes.py``); only
the paper's Gamma model with the sweep-level CV is ported."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np

from repro_torch.core import eet as eet_mod


@dataclasses.dataclass(frozen=True)
class GammaRuntimes:
    """Gamma-distributed runtimes around the EET (the paper's model).
    ``cv=None`` takes the sweep-level ``cv_run``."""

    kind: ClassVar[str] = "gamma"
    cv: Optional[float] = None

    def __post_init__(self):
        if self.cv is not None and not self.cv > 0:
            raise ValueError("cv must be positive")

    def sample(self, rng: np.random.Generator, eet, task_type,
               cv_run: float) -> np.ndarray:
        cv = self.cv if self.cv is not None else cv_run
        return eet_mod.sample_actual_exec(rng, eet, task_type, cv)
