"""Mutable, case-insensitive scenario registry (counterpart of
``repro/scenarios/registry.py``).

Scenarios are addressed by name everywhere (``SweepSpec.scenario``, the
sweep CLI's ``--scenario``, ``trace_stack``), so registering a
composition here makes it flow through the whole sweep machinery:

    from repro_torch import scenarios

    rush_hour = scenarios.Scenario(
        scenarios.MMPPArrivals(rate_ratio=12.0),
        scenarios.WeightedMix((0.5, 0.2, 0.2, 0.1)),
        scenarios.ScaledDeadlines(0.8),
        scenarios.GammaRuntimes(),
    )
    scenarios.register("rush-hour", rush_hour)
    # ... SweepSpec(scenario="rush-hour") now just works.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.registry import NameRegistry
from repro_torch.scenarios.base import Scenario


def _check(name, scenario) -> None:
    if not isinstance(scenario, Scenario):
        raise TypeError(f"scenario {name!r} must be a Scenario, "
                        f"got {scenario!r}")


_REGISTRY = NameRegistry("scenario", case=str.lower, check=_check)


def register(name: str, scenario: Scenario, *,
             overwrite: bool = False) -> Scenario:
    """Register ``scenario`` under ``name`` (case-insensitive).

    Re-registering an existing name raises unless ``overwrite=True``.
    Returns the scenario, so registration can be used expression-style.
    """
    return _REGISTRY.register(name, scenario, overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a registered scenario (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get(name: str) -> Scenario:
    """Resolve a scenario by (case-insensitive) name."""
    return _REGISTRY.get(name)


def list_scenarios() -> List[str]:
    """Sorted names of every registered scenario."""
    return _REGISTRY.names()
