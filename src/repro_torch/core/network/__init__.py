"""Registry-backed network costs: the edge-cloud hierarchy axis
(counterpart of ``repro/core/network``).

    Run = Policy x Scenario x Dispatcher x Observers x Dynamics x Network

A :class:`NetworkModel` prices each ``origin site -> chosen site`` link
per task type. The engine charges the price at the ``dispatch`` stage:
the task's ready time at the chosen site moves out by the link latency
(it cannot be mapped before it lands, and its landing drives an event),
and the link energy is charged to Eq. 2's dynamic account and tallied
per destination tier (``SimState.e_xfer``, read by the ``network``
observer). Built-ins:

  * ``none`` — free instantaneous links; the default, which the engine
    turns into no transfer arithmetic at all;
  * ``uniform_latency`` — one flat price for any cross-site hop;
  * ``tiered`` — a per-tier-pair latency/energy matrix scaled by
    task-type input sizes.

Origins are a salted counter hash over the device-tier sites
(:func:`hash_origins`), so every heuristic of a sweep sees the same
ones. Dispatchers read the per-task link costs as
``DispatchContext.xfer_lat`` / ``.xfer_energy``; ``tier_aware`` adds the
latency to each site's fastest EET.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.network.base import (
    NetworkModel,
    hash_origins,
    hash_origins_host,
    origin_sites,
)
from repro_torch.core.network.builtins import NoNetwork, Tiered, UniformLatency
from repro_torch.core.network.registry import (
    get,
    is_registered,
    list_networks,
    register,
    unregister,
)

__all__ = [
    "NetworkModel",
    "NoNetwork",
    "Tiered",
    "UniformLatency",
    "describe",
    "from_json_dict",
    "get",
    "hash_origins",
    "hash_origins_host",
    "is_registered",
    "list_networks",
    "origin_sites",
    "register",
    "resolve",
    "to_json_dict",
    "unregister",
]

#: JSON ``kind`` -> built-in model class, for spec round-tripping.
_KINDS = {cls.kind: cls for cls in (NoNetwork, UniformLatency, Tiered)}


def resolve(model) -> NetworkModel:
    """Normalize a name-or-instance to a NetworkModel instance.

    ``None`` resolves to :class:`NoNetwork` (which the engine turns into
    no network); strings resolve through the registry (KeyError on
    unknown names lists what is registered).
    """
    if model is None:
        return NoNetwork()
    if isinstance(model, str):
        return get(model)
    if not callable(getattr(model, "cost_tables", None)):
        raise TypeError(
            f"network must be a registered name or implement the "
            f"NetworkModel protocol, got {model!r}")
    return model


def describe(name_or_model) -> str:
    """One-line human description (for ``--list-networks``)."""
    m = resolve(name_or_model)
    doc = (m.__class__.__doc__ or "").strip().splitlines()
    return doc[0].rstrip(".") if doc else m.__class__.__name__


def to_json_dict(model) -> dict:
    """``{"kind": ..., <param>: ...}`` for a built-in-style model."""
    m = resolve(model)
    out = {"kind": m.kind}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if isinstance(v, tuple):
            v = [list(x) if isinstance(x, tuple) else x for x in v]
        out[f.name] = v
    return out


def from_json_dict(d: dict) -> NetworkModel:
    """Rebuild a built-in model from its :func:`to_json_dict` form."""
    kind = d.get("kind")
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown network kind {kind!r}; choose from {sorted(_KINDS)}")
    params = {k: v for k, v in d.items() if k != "kind"}
    for k, v in params.items():
        if isinstance(v, list):
            params[k] = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
    return cls(**params)


for _name, _model in [
    ("none", NoNetwork()),
    ("uniform_latency", UniformLatency()),
    ("tiered", Tiered()),
]:
    register(_name, _model)
del _name, _model
