"""Two-level dispatch: which *site* serves each task (counterpart of
``repro/core/dispatch``).

    Federation = Dispatcher (task -> site)  x  Policy (task -> machine)

A :class:`Dispatcher` picks the site of each newly-admitted task at the
engine's ``dispatch`` stage; the mapping policy then runs once per
iteration over every site's view, folded into the batch. Built-ins:
``sticky`` (the default), ``round_robin``, ``least_queued``, ``min_eet``,
``fair_spill``, ``health_aware`` (dead-home tasks re-routed under machine
dynamics), and ``tier_aware`` (``min_eet`` plus each task's transfer
latency under a network).
``with_fused_balance`` puts the least-loaded walk of ``least_queued``,
``fair_spill`` and ``health_aware`` on the ``balance_scan`` kernel.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dispatch.base import (
    DispatchContext,
    Dispatcher,
    sequential_balance,
)
from repro_torch.core.dispatch.builtins import (
    FairSpill,
    HealthAware,
    LeastQueued,
    MinEet,
    RoundRobin,
    Sticky,
    TierAware,
)
from repro_torch.core.dispatch.registry import (
    get,
    is_registered,
    list_dispatchers,
    register,
    unregister,
)

__all__ = [
    "DispatchContext",
    "Dispatcher",
    "FairSpill",
    "HealthAware",
    "LeastQueued",
    "MinEet",
    "RoundRobin",
    "Sticky",
    "TierAware",
    "describe",
    "from_json_dict",
    "get",
    "is_registered",
    "list_dispatchers",
    "register",
    "resolve",
    "sequential_balance",
    "to_json_dict",
    "unregister",
    "with_fused_balance",
]

#: JSON ``kind`` -> built-in dispatcher class, for round-tripping.
_KINDS = {cls.kind: cls for cls in (Sticky, RoundRobin, LeastQueued, MinEet,
                                    FairSpill, HealthAware, TierAware)}


def resolve(dispatcher) -> Dispatcher:
    """Normalize a name-or-instance to a Dispatcher instance.

    ``None`` resolves to the default :class:`Sticky`; strings resolve
    through the registry (KeyError on unknown names lists what is
    registered).
    """
    if dispatcher is None:
        return Sticky()
    if isinstance(dispatcher, str):
        return get(dispatcher)
    if not callable(getattr(dispatcher, "dispatch", None)):
        raise TypeError(
            f"dispatcher must be a registered name or implement the "
            f"Dispatcher protocol, got {dispatcher!r}")
    return dispatcher


def describe(name_or_dispatcher) -> str:
    """One-line human description (for ``--list-dispatchers``)."""
    d = resolve(name_or_dispatcher)
    doc = (d.__class__.__doc__ or "").strip().splitlines()
    return doc[0].rstrip(".") if doc else d.__class__.__name__


def to_json_dict(dispatcher) -> dict:
    """``{"kind": ..., <param>: ...}`` for a built-in-style dispatcher.

    The ``balance_impl`` kernel hook is skipped: a serialized dispatcher
    round-trips to the plain walk, and the runner re-applies
    ``with_fused_balance`` from its own flag.
    """
    d = resolve(dispatcher)
    out = {"kind": d.kind}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if v is None or callable(v):
            continue
        out[f.name] = v
    return out


def from_json_dict(d: dict) -> Dispatcher:
    """Rebuild a built-in dispatcher from its :func:`to_json_dict` form."""
    kind = d.get("kind")
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown dispatcher kind {kind!r}; choose from "
                         f"{sorted(_KINDS)}")
    return cls(**{k: v for k, v in d.items() if k != "kind"})


def with_fused_balance(dispatcher) -> Dispatcher:
    """Put a dispatcher's least-loaded walk on the ``balance_scan`` kernel
    (the counterpart of ``with_pallas_balance``).

    No-op for dispatchers without a ``balance_impl`` hook (``sticky``,
    ``round_robin``, ``min_eet``, ``tier_aware`` never run the walk).
    """
    d = resolve(dispatcher)
    if (not dataclasses.is_dataclass(d)
            or "balance_impl" not in {f.name for f in dataclasses.fields(d)}):
        return d
    from repro_torch.kernels.map_fused.ops import balance_scan

    return dataclasses.replace(d, balance_impl=balance_scan)


for _name, _disp in [
    ("sticky", Sticky()),
    ("round_robin", RoundRobin()),
    ("least_queued", LeastQueued()),
    ("min_eet", MinEet()),
    ("fair_spill", FairSpill()),
    ("health_aware", HealthAware()),
    ("tier_aware", TierAware()),
]:
    register(_name, _disp)
del _name, _disp
