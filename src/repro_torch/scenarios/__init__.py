"""Workload scenarios (counterpart of ``repro/scenarios``).

Only the paper's default scenario is ported: Poisson arrivals, a uniform
type mix, Eq. 4 deadlines and Gamma runtimes, registered as
``"poisson"``; the two paper fleets, ``"paper"`` and ``"aws"``; and
their federations, ``"paper_x2"`` ... ``"paper_x32"``, ``"tiered_x4"``
and ``"tiered_x16"``.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.registry import NameRegistry
from repro_torch.scenarios.arrivals import PoissonArrivals
from repro_torch.scenarios.base import Scenario
from repro_torch.scenarios.deadlines import PaperDeadlines
from repro_torch.scenarios.fleets import (
    AwsFleet,
    FederatedFleet,
    PaperFleet,
    TieredFleet,
    get_fleet,
    is_registered_fleet,
    list_fleets,
)
from repro_torch.scenarios.mixes import UniformMix
from repro_torch.scenarios.runtimes import GammaRuntimes

__all__ = [
    "AwsFleet",
    "DEFAULT",
    "FederatedFleet",
    "GammaRuntimes",
    "PaperDeadlines",
    "PaperFleet",
    "PoissonArrivals",
    "Scenario",
    "TieredFleet",
    "UniformMix",
    "get",
    "get_fleet",
    "is_registered",
    "is_registered_fleet",
    "list_fleets",
    "list_scenarios",
]

#: The paper's workload.
DEFAULT = Scenario(PoissonArrivals(), UniformMix(), PaperDeadlines(),
                   GammaRuntimes())

_SCENARIOS = NameRegistry("scenario", case=str.lower)
_SCENARIOS.register("poisson", DEFAULT)


def get(name: str) -> Scenario:
    """Resolve a scenario by (case-insensitive) name."""
    return _SCENARIOS.get(name)


def is_registered(name: str) -> bool:
    return _SCENARIOS.is_registered(name)


def list_scenarios() -> List[str]:
    return _SCENARIOS.names()
