"""Mutable, case-insensitive machine-dynamics registry (counterpart of
``repro/core/faults/registry.py``).

Dynamics are addressed by name everywhere — ``SweepSpec.dynamics``, the
sweep CLI's ``--dynamics``, ``engine.simulate(dynamics=...)``:

    from repro_torch.core import faults

    faults.register("flaky", faults.BernoulliUpDown(p_fail=0.1))
    # ... SweepSpec(system="paper_x2", dynamics="flaky") now just works.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.registry import NameRegistry


def _check(name, dynamics) -> None:
    if not callable(getattr(dynamics, "step", None)):
        raise TypeError(
            f"dynamics {name!r} must implement the MachineDynamics "
            f"protocol (a .step(ctx) method); got {dynamics!r}")


_REGISTRY = NameRegistry("dynamics", case=str.lower, check=_check)


def register(name: str, dynamics, *, overwrite: bool = False):
    """Register ``dynamics`` under ``name`` (case-insensitive); returns it.
    Re-registering an existing name raises unless ``overwrite=True``."""
    return _REGISTRY.register(name, dynamics, overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a registered dynamics (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get(name: str):
    """Resolve a dynamics by (case-insensitive) name, or raise KeyError
    listing every registered name."""
    return _REGISTRY.get(name)


def list_dynamics() -> List[str]:
    """Sorted names of every registered machine dynamics."""
    return _REGISTRY.names()
