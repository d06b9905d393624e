"""The workload-scenario algebra (counterpart of ``repro/scenarios/base.py``).

A :class:`Scenario` composes an arrival process, a type mix, a deadline
model and a runtime model, and optionally names the fleet it is meant to
run on. Randomness comes from ``numpy.random.Generator``s seeded from a
``numpy.random.SeedSequence``: one trace splits its seed three ways
(arrivals, types, runtimes), as the reference splits its key. The arrays
are drawn on the host and moved to the device; deadlines are computed
there from the arrivals.

Each stochastic component is a draw and a transform. ``draw(rng, ...)``
takes numpy draws of the distributions the reference draws (exponential,
uniform, normal, gamma, Gumbel); the transform is a pure function of
those draws and the parameters, in the reference's float32 arithmetic
(its prefix sums by :func:`repro_torch.core.equations.cumsum32`, its
exponential by ``exp32``). ``sample`` is ``transform(draw(...))``. numpy
cannot reproduce JAX's threefry streams, so a port-synthesized trace is
held to the reference in distribution; fed the reference's own draws, a
transform gives the reference's arrays.

Rates enter as float32, as the reference's ``stack`` feeds them.
Components are frozen dataclasses with a ``kind`` class attribute, so a
scenario is hashable and serializes to JSON as each component's kind and
parameters (the reference's format: either package loads the other's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Tuple, Type

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import Trace

# --------------------------------------------------------------------------
# Component protocols
# --------------------------------------------------------------------------


class ArrivalProcess(Protocol):
    """N sorted, non-negative float32 arrival times at a nominal rate.

    ``draw`` returns a tuple of arrays, each with the trace's leading
    shape; ``transform`` takes such draws with any leading dims ``L`` and
    a float32 ``rate`` broadcastable against ``L`` and returns
    ``broadcast(rate, L) + (N,)`` arrivals."""

    kind: str

    def draw(self, rng: np.random.Generator, n_tasks: int) -> tuple: ...

    def transform(self, draws: tuple, rate) -> np.ndarray: ...

    def sample(self, rng: np.random.Generator, n_tasks: int,
               rate) -> np.ndarray: ...


class TypeMix(Protocol):
    """N task-type indices in ``[0, n_types)`` (int64)."""

    kind: str

    def sample(self, rng: np.random.Generator, n_tasks: int,
               n_types: int) -> np.ndarray: ...


class DeadlineModel(Protocol):
    """Maps (arrival, task_type, eet) tensors to per-task deadlines."""

    kind: str

    def deadlines(self, arrival, task_type, eet) -> torch.Tensor: ...


class RuntimeModel(Protocol):
    """(N, M) float32 actual runtimes around the EET rows. ``cv_run`` is
    the sweep-level CV; models with their own dispersion ignore it."""

    kind: str

    def sample(self, rng: np.random.Generator, eet, task_type,
               cv_run: float) -> np.ndarray: ...


def split_seed(seed, n: int) -> list:
    """``n`` child ``SeedSequence``s of ``seed`` (an int or a
    SeedSequence), the same on every call: unlike
    ``SeedSequence.spawn``, the parent is not advanced."""
    ss = (seed if isinstance(seed, np.random.SeedSequence)
          else np.random.SeedSequence(seed))
    return [np.random.SeedSequence(ss.entropy,
                                   spawn_key=ss.spawn_key + (i,),
                                   pool_size=ss.pool_size)
            for i in range(n)]


def as_rate(rate) -> np.ndarray:
    """The rate as float32, with a trailing axis to broadcast against the
    task axis of a transform's draws."""
    return np.asarray(rate, np.float32)[..., None]


# --------------------------------------------------------------------------
# Component (de)serialization: kind-keyed class registry
# --------------------------------------------------------------------------

_COMPONENTS: Dict[Tuple[str, str], Type] = {}


def component(category: str):
    """Class decorator registering a component for JSON round trips.

    ``category`` is the Scenario field family (``"arrivals"``, ``"mix"``,
    ``"deadline"``, ``"runtime"``, ``"fleet"``); with the class's
    ``kind`` it keys the class for :func:`component_from_json`.
    """

    def deco(cls):
        key = (category, cls.kind)
        if key in _COMPONENTS and _COMPONENTS[key] is not cls:
            raise ValueError(f"duplicate component kind {key!r}")
        _COMPONENTS[key] = cls
        return cls

    return deco


def component_to_json(comp) -> dict:
    """``{"kind": ..., <param>: ...}`` for a registered component."""
    out = {"kind": comp.kind}
    for f in dataclasses.fields(comp):
        v = getattr(comp, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def component_from_json(category: str, d: dict):
    """Inverse of :func:`component_to_json` (tuples restored from lists)."""
    try:
        cls = _COMPONENTS[(category, d["kind"])]
    except KeyError:
        known = sorted(k for c, k in _COMPONENTS if c == category)
        raise ValueError(
            f"unknown {category} component kind {d.get('kind')!r}; "
            f"choose from {known}") from None
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in d.items() if k != "kind"}
    return cls(**kwargs)


# --------------------------------------------------------------------------
# Scenario
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """arrivals x mix x deadline x runtime [x fleet] — one workload recipe.

    ``fleet`` optionally names the fleet builder the scenario is designed
    for; ``None`` defers to the caller's system.
    """

    arrivals: ArrivalProcess
    mix: TypeMix
    deadline: DeadlineModel
    runtime: RuntimeModel
    fleet: Optional[object] = None  # FleetBuilder

    def _draws(self, seed, n_tasks: int, eet, cv_run: float, n_types: int):
        """One replicate's rate-free draws: (arrival draws, task types,
        actual runtimes)."""
        s_arr, s_type, s_exec = split_seed(seed, 3)
        arr = self.arrivals.draw(np.random.default_rng(s_arr), n_tasks)
        task_type = self.mix.sample(np.random.default_rng(s_type), n_tasks,
                                    n_types)
        exec_actual = self.runtime.sample(np.random.default_rng(s_exec),
                                          eet, task_type, cv_run)
        return arr, task_type, exec_actual

    def sample_arrays(self, seed, n_tasks: int, rate, eet, *,
                      cv_run: float = 0.1, n_task_types=None):
        """Host arrays of one trace: (arrival f32, task_type int64,
        exec_actual f32). The rate only enters the arrival transform, so
        one seed gives the same types and runtimes at every rate."""
        eet = np.asarray(eet, np.float32)
        S = eet.shape[0] if n_task_types is None else int(n_task_types)
        arr, task_type, exec_actual = self._draws(seed, n_tasks, eet,
                                                  cv_run, S)
        return (self.arrivals.transform(arr, np.float32(rate)), task_type,
                exec_actual)

    def _trace(self, arrival, task_type, exec_actual, eet, dev) -> Trace:
        arrival = torch.as_tensor(arrival, device=dev)
        # drawn as int64 (that draw fixes the stream), kept as int32
        task_type = torch.as_tensor(np.asarray(task_type, np.int32),
                                    device=dev)
        eet_t = torch.as_tensor(np.asarray(eet, np.float32), device=dev)
        return Trace(arrival, task_type,
                     self.deadline.deadlines(arrival, task_type, eet_t),
                     torch.as_tensor(exec_actual, device=dev))

    def sample_trace(self, seed, n_tasks: int, rate, eet, *,
                     cv_run: float = 0.1, n_task_types=None,
                     device=None) -> Trace:
        """Synthesize one workload trace on ``device`` (None = CUDA)."""
        dev = resolve_device(device)
        arrays = self.sample_arrays(seed, n_tasks, rate, eet, cv_run=cv_run,
                                    n_task_types=n_task_types)
        return self._trace(*arrays, eet, dev)

    def stack(self, seed, rates, reps: int, n_tasks: int, eet, *,
              cv_run: float = 0.1, n_task_types=None, device=None) -> Trace:
        """The (R rates x K replicates) trace grid under one seed.

        Replicate ``k`` uses the same child seed at every rate (common
        random numbers): its draws are taken once, and only the arrival
        transform, applied to all K replicates at once, sees the rate.
        Leaves carry leading dims (R, K).
        """
        dev = resolve_device(device)
        eet = np.asarray(eet, np.float32)
        S = eet.shape[0] if n_task_types is None else int(n_task_types)
        arr, task_type, exec_actual = zip(*(
            self._draws(s, n_tasks, eet, cv_run, S)
            for s in split_seed(seed, reps)))
        draws = tuple(np.stack(d) for d in zip(*arr))          # (K, ...)
        rates = np.asarray(rates, np.float32)
        arrival = self.arrivals.transform(draws, rates[:, None])
        R = len(rates)
        task_type, exec_actual = (
            np.repeat(np.stack(x)[None], R, axis=0)
            for x in (task_type, exec_actual))
        return self._trace(arrival, task_type, exec_actual, eet, dev)

    # -- introspection / serialization -------------------------------------
    def describe(self) -> dict:
        """Component kinds by field, for ``--list-scenarios`` output."""
        return {
            "arrivals": self.arrivals.kind,
            "mix": self.mix.kind,
            "deadline": self.deadline.kind,
            "runtime": self.runtime.kind,
            "fleet": self.fleet.kind if self.fleet is not None else "-",
        }

    def to_json_dict(self) -> dict:
        return {
            "arrivals": component_to_json(self.arrivals),
            "mix": component_to_json(self.mix),
            "deadline": component_to_json(self.deadline),
            "runtime": component_to_json(self.runtime),
            "fleet": (component_to_json(self.fleet)
                      if self.fleet is not None else None),
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "Scenario":
        return cls(
            arrivals=component_from_json("arrivals", d["arrivals"]),
            mix=component_from_json("mix", d["mix"]),
            deadline=component_from_json("deadline", d["deadline"]),
            runtime=component_from_json("runtime", d["runtime"]),
            fleet=(component_from_json("fleet", d["fleet"])
                   if d.get("fleet") is not None else None),
        )


def replace(scenario: Scenario, **kwargs) -> Scenario:
    """``dataclasses.replace`` re-exported for fluent scenario tweaking."""
    return dataclasses.replace(scenario, **kwargs)
