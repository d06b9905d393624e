"""The ``energy_budget`` dynamic observer: a finite battery as a runtime
constraint (counterpart of ``repro/core/observe/energy.py``).

:class:`EnergyBudget` realizes Eq. 2's energy-limited regime: it tracks
each replicate's cumulative dynamic + idle energy against a battery
``capacity`` and latches an ``exhausted`` flag. The engine feeds that
flag back: once a replicate is exhausted it stops admitting work — no
new arrivals enter, pending tasks are cancelled, local queues are
flushed with zero energy — while tasks already executing run to
completion.

With the default ``capacity=inf`` the observer is not dynamic and the
engine holds no gating op at all.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import equations
from repro_torch.core.observe.base import Observer


@dataclasses.dataclass(frozen=True)
class EnergyBudget(Observer):
    """Track cumulative energy against a battery ``capacity`` (power-profile
    units × seconds). Result tree, each (B,): ``exhausted`` bool,
    ``e_total`` f32 (dynamic + idle at the last completion event),
    ``t_exhausted`` f32 (time the budget ran out, inf if it never did),
    ``capacity`` f32.
    """

    capacity: float = math.inf
    name: str = "energy_budget"

    summary = ("Finite battery capacity; halts admission once cumulative "
               "energy exhausts it")

    @property
    def is_dynamic(self) -> bool:
        # capacity=inf is "unset": keep the admission gate out of the loop
        return math.isfinite(self.capacity)

    def init(self, trace, sysarr):
        B, dev = trace.arrival.shape[0], trace.arrival.device

        def full(value):
            return torch.full((B,), value, dtype=torch.float32, device=dev)

        return {
            "exhausted": torch.zeros(B, dtype=torch.bool, device=dev),
            "e_total": full(0.0),
            "t_exhausted": full(math.inf),
            "capacity": full(self.capacity),
        }

    def on_event(self, stage, aux, st, trace, sysarr):
        if stage != "finalize":  # energy only accrues at completions
            return aux
        idle = st.now[:, None] - st.busy_time
        e_total = st.e_dyn + equations.seq_dot(sysarr.p_idle, idle)
        exhausted = aux["exhausted"] | (e_total >= aux["capacity"])
        newly = exhausted & ~aux["exhausted"]
        return {
            **aux,
            "exhausted": exhausted,
            "e_total": e_total,
            "t_exhausted": torch.where(newly, st.now, aux["t_exhausted"]),
        }

    def halted(self, aux, st):
        return aux["exhausted"]

    def to_json_dict(self) -> dict:
        cap = None if math.isinf(self.capacity) else float(self.capacity)
        return {"kind": "energy_budget", "capacity": cap, "name": self.name}

    @classmethod
    def from_json_dict(cls, d: dict) -> "EnergyBudget":
        cap = d.get("capacity", math.inf)
        return cls(capacity=math.inf if cap in (None, "inf") else float(cap),
                   name=d.get("name", "energy_budget"))
