"""Sweep configuration (counterpart of ``repro/experiments/spec.py``).

A :class:`SweepSpec` fixes a batched Monte-Carlo experiment — system,
scenario, arrival rates, replicates, heuristics, seed, dispatcher,
machine dynamics, network — so a sweep is reproducible from its spec
alone. Heuristic names resolve through :mod:`repro_torch.core.policy`,
scenario names through :mod:`repro_torch.scenarios`, dispatcher names
through :mod:`repro_torch.core.dispatch`, dynamics names through
:mod:`repro_torch.core.faults`, network names through
:mod:`repro_torch.core.network`, system names through the fleet
registry (``"paper"``, ``"cvb"``, ``"mixed_sites"``, ``"paper_x8"``, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core.types import SystemSpec

DEFAULT_HEURISTICS = ("MM", "MSD", "MMU", "ELARE", "FELARE")
DEFAULT_RATES = (2.0, 3.0, 4.0, 6.0, 8.0)


def parse_rates(text: str) -> tuple[float, ...]:
    """Parse a CLI rate grid: ``"a,b,c"`` or an inclusive
    ``"start:stop[:step]"`` range."""
    text = text.strip()
    if ":" in text:
        parts = [float(p) for p in text.split(":")]
        if len(parts) == 2:
            start, stop, step = parts[0], parts[1], 1.0
        elif len(parts) == 3:
            start, stop, step = parts
        else:
            raise ValueError(f"bad rate range {text!r}; want start:stop[:step]")
        if step <= 0:
            raise ValueError(f"rate step must be positive, got {step}")
        out = []
        r = start
        while r <= stop + 1e-9:
            out.append(round(r, 9))
            r += step
        return tuple(out)
    return tuple(float(p) for p in text.split(",") if p.strip())


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A batched Monte-Carlo sweep over (rates x replicates x heuristics).

    Attributes mirror the JAX ``SweepSpec``. ``system`` is a registered
    fleet name, a SystemSpec, or ``None`` for the scenario's own fleet
    (``"paper"`` when it has none); ``scenario`` is a registered name or a
    :class:`repro_torch.scenarios.Scenario`. ``use_fused_phase1`` and
    ``use_fused_map`` are the counterparts of ``use_pallas_phase1`` and
    ``use_pallas_map`` (both off by default): they route ELARE's Phase I,
    or the whole map decision and the dispatcher's balance walk, through
    the port's CUDA kernels. ``dispatcher`` is the federation's
    site-selection rule, a registered name or a dispatcher instance; a
    single-site system has no dispatch stage, so it changes nothing
    there. ``dynamics`` is the machine-failure process, a registered name
    (built-ins: ``"none"``, ``"bernoulli_updown"``, ``"site_outage"``,
    ``"degrade"``) or a ``faults.MachineDynamics`` instance; ``"none"``
    runs the sweep without faults. ``network`` is the edge-cloud
    transfer-cost model, a registered name (built-ins: ``"none"``,
    ``"uniform_latency"``, ``"tiered"``) or a ``network.NetworkModel``
    instance; ``"none"`` runs the sweep with free links. ``observers``
    are engine observers, registered names (built-ins: ``"timeline"``,
    ``"fairness_trajectory"``, ``"task_log"``, ``"energy_budget"``,
    ``"health"``, ``"network"``) or
    :class:`repro_torch.core.observe.Observer` instances; their results
    come back on :attr:`SweepResult.aux` stacked under the same (H, R, K)
    dims as the metrics.
    """

    system: Union[str, SystemSpec, None] = None
    rates: tuple[float, ...] = DEFAULT_RATES
    reps: int = 8
    n_tasks: int = 400
    heuristics: tuple[str, ...] = DEFAULT_HEURISTICS
    seed: int = 0
    cv_run: float = 0.1
    queue_size: Optional[int] = None
    fairness_factor: Optional[float] = None
    use_fused_phase1: bool = False
    use_fused_map: bool = False
    max_steps: Optional[int] = None
    scenario: Union[str, object] = "poisson"  # name or scenarios.Scenario
    dispatcher: Union[str, object] = "sticky"
    observers: tuple = ()
    dynamics: Union[str, object] = "none"
    network: Union[str, object] = "none"

    def __post_init__(self):
        object.__setattr__(self, "rates",
                           tuple(float(r) for r in self.rates))
        object.__setattr__(self, "heuristics",
                           tuple(h.upper() for h in self.heuristics))
        if self.reps < 1:
            raise ValueError("reps must be >= 1")
        if self.n_tasks < 1:
            raise ValueError("n_tasks must be >= 1")
        if not self.rates:
            raise ValueError("rates must be non-empty")
        if not self.heuristics:
            raise ValueError("heuristics must be non-empty")
        from repro_torch import scenarios
        from repro_torch.core import policy

        unknown = [h for h in self.heuristics if not policy.is_registered(h)]
        if unknown:
            raise ValueError(f"unknown heuristics {unknown}; choose from "
                             f"{policy.list_policies()}")
        if isinstance(self.scenario, str):
            if not scenarios.is_registered(self.scenario):
                raise ValueError(
                    f"unknown scenario {self.scenario!r}; "
                    f"choose from {scenarios.list_scenarios()} "
                    f"(or scenarios.register(...) your own)")
        elif not isinstance(self.scenario, scenarios.Scenario):
            raise ValueError(
                f"scenario must be a registered name or a "
                f"scenarios.Scenario, got {self.scenario!r}")
        from repro_torch.core import dispatch

        if isinstance(self.dispatcher, str):
            name = self.dispatcher.strip().lower()
            if not dispatch.is_registered(name):
                raise ValueError(
                    f"unknown dispatcher {self.dispatcher!r}; "
                    f"choose from {dispatch.list_dispatchers()} "
                    f"(or dispatch.register(...) your own)")
            object.__setattr__(self, "dispatcher", name)
        elif not callable(getattr(self.dispatcher, "dispatch", None)):
            raise ValueError(
                f"dispatcher must be a registered name or a "
                f"dispatch.Dispatcher, got {self.dispatcher!r}")
        from repro_torch.core import faults

        if isinstance(self.dynamics, str):
            name = self.dynamics.strip().lower()
            if not faults.is_registered(name):
                raise ValueError(
                    f"unknown dynamics {self.dynamics!r}; "
                    f"choose from {faults.list_dynamics()} "
                    f"(or faults.register(...) your own)")
            object.__setattr__(self, "dynamics", name)
        elif not callable(getattr(self.dynamics, "step", None)):
            raise ValueError(
                f"dynamics must be a registered name or a "
                f"faults.MachineDynamics, got {self.dynamics!r}")
        from repro_torch.core import network

        if isinstance(self.network, str):
            name = self.network.strip().lower()
            if not network.is_registered(name):
                raise ValueError(
                    f"unknown network {self.network!r}; "
                    f"choose from {network.list_networks()} "
                    f"(or network.register(...) your own)")
            object.__setattr__(self, "network", name)
        elif not callable(getattr(self.network, "cost_tables", None)):
            raise ValueError(
                f"network must be a registered name or a "
                f"network.NetworkModel, got {self.network!r}")
        from repro_torch.core import observe

        obs = []
        for ob in (self.observers if not isinstance(self.observers, str)
                   else (self.observers,)):
            if isinstance(ob, str):
                name = ob.strip().lower()
                if not observe.is_registered(name):
                    raise ValueError(
                        f"unknown observer {ob!r}; "
                        f"choose from {observe.list_observers()} "
                        f"(or observe.register(...) your own)")
                obs.append(name)
            else:
                try:  # one protocol check: the registry's
                    observe.resolve((ob,))
                except TypeError as e:
                    raise ValueError(str(e)) from None
                obs.append(ob)
        object.__setattr__(self, "observers", tuple(obs))

    @property
    def n_simulations(self) -> int:
        return len(self.heuristics) * len(self.rates) * self.reps

    def resolve_observers(self) -> tuple:
        """Materialize the :class:`repro_torch.core.observe.Observer`
        tuple."""
        from repro_torch.core import observe

        return observe.resolve(self.observers)

    def resolve_dynamics(self):
        """Materialize the :class:`repro_torch.core.faults.MachineDynamics`."""
        from repro_torch.core import faults

        return faults.resolve(self.dynamics)

    def resolve_network(self):
        """Materialize the :class:`repro_torch.core.network.NetworkModel`."""
        from repro_torch.core import network

        return network.resolve(self.network)

    def resolve_scenario(self):
        """Materialize the :class:`repro_torch.scenarios.Scenario`."""
        from repro_torch import scenarios

        if isinstance(self.scenario, scenarios.Scenario):
            return self.scenario
        return scenarios.get(str(self.scenario))

    def resolve_system(self) -> SystemSpec:
        """The SystemSpec, with the queue-size / fairness overrides. An
        explicit SystemSpec or fleet name wins; ``system=None`` takes the
        scenario's own fleet, or the paper system when it has none."""
        from repro_torch import scenarios

        if isinstance(self.system, SystemSpec):
            sys_spec = self.system
        elif self.system is None:
            fleet = self.resolve_scenario().fleet
            if fleet is None:
                fleet = scenarios.get_fleet("paper")
            sys_spec = fleet.build()
        else:
            try:
                sys_spec = scenarios.get_fleet(str(self.system)).build()
            except KeyError:
                raise ValueError(f"unknown system {self.system!r}; choose "
                                 f"from {scenarios.list_fleets()} or pass a "
                                 f"SystemSpec") from None
        overrides = {}
        if self.queue_size is not None:
            overrides["queue_size"] = int(self.queue_size)
        if self.fairness_factor is not None:
            overrides["fairness_factor"] = float(self.fairness_factor)
        if overrides:
            sys_spec = dataclasses.replace(sys_spec, **overrides)
        return sys_spec

    def to_json_dict(self) -> dict:
        """JSON-ready record of the spec (written into ``sweep.json``)."""
        from repro_torch.core import dispatch, faults, network

        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        if isinstance(self.system, SystemSpec):
            d["system"] = {
                "eet": [[float(x) for x in row] for row in self.system.eet],
                "p_dyn": [float(x) for x in self.system.p_dyn],
                "p_idle": [float(x) for x in self.system.p_idle],
                "queue_size": self.system.queue_size,
                "fairness_factor": self.system.fairness_factor,
                "site_of_machine": self.system.site_of_machine,
                "tier_of_site": self.system.tier_of_site,
            }
        if not isinstance(self.scenario, str):
            d["scenario"] = self.scenario.to_json_dict()
        if not isinstance(self.dispatcher, str):
            d["dispatcher"] = dispatch.to_json_dict(self.dispatcher)
        if not isinstance(self.dynamics, str):
            d["dynamics"] = faults.to_json_dict(self.dynamics)
        if not isinstance(self.network, str):
            d["network"] = network.to_json_dict(self.network)
        observers = []
        for ob in self.observers:
            if isinstance(ob, str):
                observers.append(ob)
            elif hasattr(ob, "to_json_dict"):
                observers.append(ob.to_json_dict())
            else:
                raise ValueError(
                    f"observer {ob!r} has no to_json_dict; register it and "
                    f"pass the name to make the spec serializable")
        d["observers"] = observers
        d["rates"] = list(self.rates)
        d["heuristics"] = list(self.heuristics)
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "SweepSpec":
        """Rebuild a spec from :meth:`to_json_dict` output (the ``"spec"``
        block of a saved ``sweep.json``). A payload without a network
        (written before the network existed) loads with ``"none"``."""
        from repro_torch import scenarios
        from repro_torch.core import dispatch, faults, network, observe

        d = dict(d)
        system = d.get("system")
        if isinstance(system, dict):
            sites = system.get("site_of_machine")
            tiers = system.get("tier_of_site")
            system = SystemSpec(
                eet=np.asarray(system["eet"], np.float32),
                p_dyn=np.asarray(system["p_dyn"], np.float32),
                p_idle=np.asarray(system["p_idle"], np.float32),
                queue_size=int(system.get("queue_size", 2)),
                fairness_factor=float(system.get("fairness_factor", 1.0)),
                site_of_machine=None if sites is None else tuple(sites),
                tier_of_site=None if tiers is None else tuple(tiers))
        dispatcher = d.get("dispatcher", "sticky")
        if isinstance(dispatcher, dict):
            dispatcher = dispatch.from_json_dict(dispatcher)
        dynamics = d.get("dynamics", "none")
        if isinstance(dynamics, dict):
            dynamics = faults.from_json_dict(dynamics)
        scenario = d.get("scenario", "poisson")
        if isinstance(scenario, dict):
            scenario = scenarios.Scenario.from_json_dict(scenario)
        net = d.get("network", "none")
        if isinstance(net, dict):
            net = network.from_json_dict(net)
        return cls(
            system=system,
            rates=tuple(d["rates"]),
            reps=int(d["reps"]),
            n_tasks=int(d["n_tasks"]),
            heuristics=tuple(d["heuristics"]),
            seed=int(d["seed"]),
            cv_run=float(d["cv_run"]),
            queue_size=d.get("queue_size"),
            fairness_factor=d.get("fairness_factor"),
            use_fused_phase1=bool(d.get("use_fused_phase1", False)),
            use_fused_map=bool(d.get("use_fused_map", False)),
            max_steps=d.get("max_steps"),
            scenario=scenario,
            dispatcher=dispatcher,
            observers=tuple(observe.from_json_dict(ob)
                            if isinstance(ob, dict) else ob
                            for ob in d.get("observers", ())),
            dynamics=dynamics,
            network=net)


def replace(spec: SweepSpec, **kwargs) -> SweepSpec:
    """``dataclasses.replace`` re-exported for fluent spec tweaking."""
    return dataclasses.replace(spec, **kwargs)
