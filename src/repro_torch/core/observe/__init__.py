"""Engine observers (counterpart of ``repro/core/observe/``).

    Observer = init × on_event(stage, ...) × finalize  [× halted]

Built-ins, all fixed-shape tensors batched over the engine's replicates:

  * ``timeline`` — :class:`Timeline`, K-bucket queue-occupancy / energy /
    per-type completion time series (``per_site=True`` adds per-site
    series on a federation);
  * ``fairness_trajectory`` — :class:`FairnessTrajectory`, the Alg. 4
    suffered-type indicator over time;
  * ``task_log`` — :class:`TaskLog`, per-task map/start/end times, final
    status, machine and site;
  * ``energy_budget`` — :class:`EnergyBudget`, the dynamic observer: a
    finite battery capacity the engine consults to stop admitting work
    (inert at the default ``capacity=inf``);
  * ``health`` — :class:`Health`, K-bucket healthy-machine, site-heartbeat
    and orphan-pressure series of the faults subsystem;
  * ``network`` — :class:`Network`, K-bucket per-tier load, per-tier
    transfer energy and in-transit series of the network subsystem.
"""
from __future__ import annotations

from repro_torch.core.observe.base import (
    Observer,
    bucket_index,
    forward_fill,
    tree_map,
)
from repro_torch.core.observe.energy import EnergyBudget
from repro_torch.core.observe.health import Health
from repro_torch.core.observe.network import Network
from repro_torch.core.observe.registry import (
    get,
    is_registered,
    list_observers,
    register,
    resolve,
    unregister,
)
from repro_torch.core.observe.tasklog import TaskLog
from repro_torch.core.observe.timeline import FairnessTrajectory, Timeline

__all__ = [
    "EnergyBudget",
    "FairnessTrajectory",
    "Health",
    "Network",
    "Observer",
    "TaskLog",
    "Timeline",
    "bucket_index",
    "describe",
    "forward_fill",
    "from_json_dict",
    "get",
    "is_registered",
    "list_observers",
    "register",
    "resolve",
    "tree_map",
    "unregister",
]

#: JSON ``kind`` -> built-in observer class, for spec round-tripping.
_KINDS = {
    "timeline": Timeline,
    "fairness_trajectory": FairnessTrajectory,
    "task_log": TaskLog,
    "energy_budget": EnergyBudget,
    "health": Health,
    "network": Network,
}


def from_json_dict(d: dict):
    """Rebuild a built-in observer from its ``to_json_dict`` form."""
    kind = d.get("kind")
    if kind not in _KINDS:
        raise ValueError(
            f"unknown observer kind {kind!r}; choose from {sorted(_KINDS)}")
    cls = _KINDS[kind]
    params = {k: v for k, v in d.items() if k != "kind"}
    if hasattr(cls, "from_json_dict"):
        return cls.from_json_dict(params)
    return cls(**params)


def describe(name_or_observer) -> str:
    """One-line human description of an observer (for ``--list-observers``)."""
    ob = (get(name_or_observer) if isinstance(name_or_observer, str)
          else name_or_observer)
    doc = (ob.__class__.__doc__ or "").strip().splitlines()
    head = getattr(ob, "summary", None) or (
        doc[0].rstrip(".") if doc else ob.__class__.__name__)
    tag = " [dynamic]" if getattr(ob, "is_dynamic", False) else ""
    return f"{head}{tag}"


for _name, _ob in [
    ("timeline", Timeline()),
    ("fairness_trajectory", FairnessTrajectory()),
    ("task_log", TaskLog()),
    ("energy_budget", EnergyBudget()),
    ("health", Health()),
    ("network", Network()),
]:
    register(_name, _ob)
del _name, _ob
