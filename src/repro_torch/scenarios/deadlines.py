"""Deadline models (counterpart of ``repro/scenarios/deadlines.py``).

``deadlines(arrival, task_type, eet)`` maps tensors on the device to
``(N,)`` float32 absolute deadlines.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core import equations
from repro_torch.scenarios.base import component


@component("deadline")
@dataclasses.dataclass(frozen=True)
class PaperDeadlines:
    """Eq. 4 verbatim: delta_k = arr_k + e_bar_i + e_bar."""

    kind: ClassVar[str] = "paper"

    def deadlines(self, arrival, task_type, eet) -> torch.Tensor:
        return equations.deadlines(arrival, task_type, eet)


@component("deadline")
@dataclasses.dataclass(frozen=True)
class ScaledDeadlines:
    """Eq. 4 with a tightness knob: delta_k = arr_k + tightness (e_bar_i +
    e_bar). ``tightness = 1`` is :class:`PaperDeadlines`, below 1 squeezes
    the slack, above 1 relaxes it.

    Two roundings, a product and then a sum, as the reference's
    op-by-op synthesis forms it (no fused multiply-add).
    """

    kind: ClassVar[str] = "scaled"
    tightness: float = 0.75

    def __post_init__(self):
        if not self.tightness > 0:
            raise ValueError("tightness must be positive")

    def deadlines(self, arrival, task_type, eet) -> torch.Tensor:
        arrival = arrival.to(equations.F32)
        # Eq. 4 at arrival 0 is exactly the slack e_bar_i + e_bar
        slack = equations.deadlines(torch.zeros_like(arrival), task_type,
                                    eet)
        tight = torch.tensor(self.tightness, dtype=equations.F32,
                             device=arrival.device)
        return arrival + tight * slack
