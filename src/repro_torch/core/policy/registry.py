"""Mutable, case-insensitive policy registry (counterpart of
``repro/core/policy/registry.py``), on the port's own
:class:`~repro_torch.core.registry.NameRegistry`."""
from __future__ import annotations

from typing import List

from repro_torch.core.registry import NameRegistry


def _check(name, policy) -> None:
    if not callable(policy):
        raise TypeError(f"policy {name!r} must be callable, got {policy!r}")


_REGISTRY = NameRegistry("policy", case=str.upper, check=_check)


def register(name: str, policy, *, overwrite: bool = False):
    """Register ``policy`` under ``name`` (case-insensitive)."""
    return _REGISTRY.register(name, policy, overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a registered policy (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get(name: str):
    """Resolve a policy by (case-insensitive) name, or raise KeyError."""
    return _REGISTRY.get(name)


def list_policies() -> List[str]:
    """Sorted names of every registered policy."""
    return _REGISTRY.names()
