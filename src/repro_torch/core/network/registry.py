"""Mutable, case-insensitive network-model registry (counterpart of
``repro/core/network/registry.py``).

Network models are addressed by name everywhere — ``SweepSpec.network``,
the sweep CLI's ``--network``, ``engine.simulate(network=...)``:

    from repro_torch.core import network

    network.register("wan", network.UniformLatency(latency=1.0))
    # ... SweepSpec(system="tiered_x4", network="wan") now just works.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.registry import NameRegistry


def _check(name, model) -> None:
    if not callable(getattr(model, "cost_tables", None)):
        raise TypeError(
            f"network {name!r} must implement the NetworkModel protocol "
            f"(a .cost_tables(tier_of_site, n_types) method); got {model!r}")


_REGISTRY = NameRegistry("network", case=str.lower, check=_check)


def register(name: str, model, *, overwrite: bool = False):
    """Register ``model`` under ``name`` (case-insensitive); returns it.
    Re-registering an existing name raises unless ``overwrite=True``."""
    return _REGISTRY.register(name, model, overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a registered network model (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get(name: str):
    """Resolve a network model by (case-insensitive) name, or raise
    KeyError listing every registered name."""
    return _REGISTRY.get(name)


def list_networks() -> List[str]:
    """Sorted names of every registered network model."""
    return _REGISTRY.names()
