"""Mutable, case-insensitive observer registry (counterpart of
``repro/core/observe/registry.py``).

Observers are addressed by name everywhere — ``SweepSpec.observers``,
the sweep CLI's ``--observers``, ``engine.simulate(observers=...)``:

    from repro_torch.core import observe

    observe.register("budget-500", observe.EnergyBudget(capacity=500.0))
    # ... SweepSpec(observers=("timeline", "budget-500")) now just works.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.registry import NameRegistry

_PROTOCOL = ("init", "on_event", "finalize")


def _check(name, observer) -> None:
    missing = [m for m in _PROTOCOL if not callable(getattr(observer, m, None))]
    if missing:
        raise TypeError(
            f"observer {name!r} must implement the Observer protocol "
            f"(init/on_event/finalize); {observer!r} lacks {missing}")


_REGISTRY = NameRegistry("observer", case=str.lower, check=_check)


def register(name: str, observer, *, overwrite: bool = False):
    """Register ``observer`` under ``name`` (case-insensitive).

    The registered name becomes the observer's ``name`` — the key of its
    slice of the engine aux and of ``SweepResult.aux`` — where ``name``
    is a dataclass field, as on every built-in. Returns the (possibly
    rebound) observer.
    """
    key = _REGISTRY.canon(name)
    if (dataclasses.is_dataclass(observer)
            and any(f.name == "name" for f in dataclasses.fields(observer))
            and getattr(observer, "name", key) != key):
        observer = dataclasses.replace(observer, name=key)
    return _REGISTRY.register(name, observer, overwrite=overwrite)


def unregister(name: str) -> None:
    """Remove a registered observer (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get(name: str):
    """Resolve an observer by (case-insensitive) name."""
    return _REGISTRY.get(name)


def list_observers() -> List[str]:
    """Sorted names of every registered observer."""
    return _REGISTRY.names()


def resolve(observers) -> tuple:
    """Normalize a mixed names/instances sequence to an instance tuple
    (a single name or instance is taken as a one-element sequence)."""
    if observers is None:
        return ()
    if isinstance(observers, str) or not hasattr(observers, "__iter__"):
        observers = (observers,)
    out = []
    for ob in observers:
        if isinstance(ob, str):
            ob = get(ob)
        else:
            _check(getattr(ob, "name", ob), ob)
        out.append(ob)
    return tuple(out)
