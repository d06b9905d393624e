"""Deadline models (counterpart of ``repro/scenarios/deadlines.py``);
only Eq. 4 is ported."""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core import equations


@dataclasses.dataclass(frozen=True)
class PaperDeadlines:
    """Eq. 4 verbatim: delta_k = arr_k + e_bar_i + e_bar."""

    kind: ClassVar[str] = "paper"

    def deadlines(self, arrival, task_type, eet) -> torch.Tensor:
        return equations.deadlines(arrival, task_type, eet)
