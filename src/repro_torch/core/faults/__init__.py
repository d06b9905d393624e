"""Registry-backed machine dynamics: failures, outages and stragglers
(counterpart of ``repro/core/faults``).

A :class:`MachineDynamics` evolves a per-machine ``(alive, slowdown)``
health state at the engine's ``faults`` stage (after ``admit``, before
``dispatch``), on every replicate of the batch. Built-ins:

  * ``none`` — no failures; the default, which skips the stage entirely;
  * ``bernoulli_updown`` — independent per-machine fail/recover chain,
    counter-hash keyed, so every heuristic of a sweep sees the same
    failures;
  * ``site_outage`` — scheduled whole-site outage windows, with engine
    wake-ups at the window edges;
  * ``degrade`` — stragglers: a slowdown factor scaling EET columns and
    runtimes instead of killing the machine.

Dead machines read avail=BIG/EET=BIG like out-of-site machines; tasks
queued or running on a dying machine become orphans that re-enter
dispatch with a bounded retry count; dispatchers see a site-health mask
("site alive iff >= 1 healthy machine"). :func:`with_backup` adds k-failure
backup nomination, and the ``health_aware`` dispatcher routes admissions
around dead sites.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.faults.backup import BackupPolicy, with_backup
from repro_torch.core.faults.base import (
    FaultContext,
    MachineDynamics,
    hash_uniform,
    hash_uniform_host,
)
from repro_torch.core.faults.builtins import (
    BernoulliUpDown,
    Degrade,
    NoDynamics,
    SiteOutage,
)
from repro_torch.core.faults.registry import (
    get,
    is_registered,
    list_dynamics,
    register,
    unregister,
)

__all__ = [
    "BackupPolicy",
    "BernoulliUpDown",
    "Degrade",
    "FaultContext",
    "MachineDynamics",
    "NoDynamics",
    "SiteOutage",
    "describe",
    "from_json_dict",
    "get",
    "hash_uniform",
    "hash_uniform_host",
    "is_registered",
    "list_dynamics",
    "register",
    "resolve",
    "to_json_dict",
    "unregister",
    "with_backup",
]

#: JSON ``kind`` -> built-in dynamics class, for spec round-tripping.
_KINDS = {cls.kind: cls for cls in (NoDynamics, BernoulliUpDown, SiteOutage,
                                    Degrade)}


def resolve(dynamics) -> MachineDynamics:
    """Normalize a name-or-instance to a MachineDynamics instance.

    ``None`` resolves to :class:`NoDynamics` (which the engine turns into
    "no faults stage at all"); strings resolve through the registry
    (KeyError on unknown names lists what is registered).
    """
    if dynamics is None:
        return NoDynamics()
    if isinstance(dynamics, str):
        return get(dynamics)
    if not callable(getattr(dynamics, "step", None)):
        raise TypeError(
            f"dynamics must be a registered name or implement the "
            f"MachineDynamics protocol, got {dynamics!r}")
    return dynamics


def describe(name_or_dynamics) -> str:
    """One-line human description (for ``--list-dynamics``)."""
    d = resolve(name_or_dynamics)
    doc = (d.__class__.__doc__ or "").strip().splitlines()
    return doc[0].rstrip(".") if doc else d.__class__.__name__


def to_json_dict(dynamics) -> dict:
    """``{"kind": ..., <param>: ...}`` for a built-in-style dynamics."""
    d = resolve(dynamics)
    out = {"kind": d.kind}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if isinstance(v, tuple):
            v = [list(x) if isinstance(x, tuple) else x for x in v]
        out[f.name] = v
    return out


def from_json_dict(d: dict) -> MachineDynamics:
    """Rebuild a built-in dynamics from its :func:`to_json_dict` form."""
    kind = d.get("kind")
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown dynamics kind {kind!r}; choose from {sorted(_KINDS)}")
    params = {k: v for k, v in d.items() if k != "kind"}
    for k, v in params.items():
        if isinstance(v, list):
            params[k] = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
    return cls(**params)


for _name, _dyn in [
    ("none", NoDynamics()),
    ("bernoulli_updown", BernoulliUpDown()),
    ("site_outage", SiteOutage()),
    ("degrade", Degrade()),
]:
    register(_name, _dyn)
del _name, _dyn
