"""Mutable, case-insensitive dispatcher registry (counterpart of
``repro/core/dispatch/registry.py``).

Dispatchers are addressed by name everywhere — ``SweepSpec.dispatcher``,
the sweep CLI's ``--dispatcher``, ``engine.simulate(dispatcher=...)``.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.registry import NameRegistry


def _check(name, dispatcher) -> None:
    if not callable(getattr(dispatcher, "dispatch", None)):
        raise TypeError(
            f"dispatcher {name!r} must implement the Dispatcher protocol "
            f"(a .dispatch(ctx) method); got {dispatcher!r}")


_REGISTRY = NameRegistry("dispatcher", case=str.lower, check=_check)


def register(name: str, dispatcher, *, overwrite: bool = False):
    """Register ``dispatcher`` under ``name`` (case-insensitive)."""
    return _REGISTRY.register(name, dispatcher, overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a registered dispatcher (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get(name: str):
    """Resolve a dispatcher by (case-insensitive) name, or raise KeyError
    listing every registered name."""
    return _REGISTRY.get(name)


def list_dispatchers() -> List[str]:
    """Sorted names of every registered dispatcher."""
    return _REGISTRY.names()
