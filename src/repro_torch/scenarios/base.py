"""The workload-scenario algebra (counterpart of ``repro/scenarios/base.py``).

A :class:`Scenario` composes an arrival process, a type mix, a deadline
model and a runtime model. Randomness comes from
``numpy.random.Generator``s seeded from a ``numpy.random.SeedSequence``:
one trace splits its seed three ways (arrivals, types, runtimes), as the
reference splits its key. The arrays are drawn on the host and moved to
the device; deadlines are computed there from the arrivals (Eq. 4).

numpy cannot reproduce JAX's threefry streams, so a port-synthesized
trace is held to the reference in distribution, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.types import Trace


class ArrivalProcess(Protocol):
    """Samples N sorted, non-negative float32 arrival times at ``rate``."""

    kind: str

    def sample(self, rng: np.random.Generator, n_tasks: int,
               rate: float) -> np.ndarray: ...


class TypeMix(Protocol):
    """Samples N task-type indices in ``[0, n_types)``."""

    kind: str

    def sample(self, rng: np.random.Generator, n_tasks: int,
               n_types: int) -> np.ndarray: ...


class DeadlineModel(Protocol):
    """Maps (arrival, task_type, eet) tensors to per-task deadlines."""

    kind: str

    def deadlines(self, arrival, task_type, eet) -> torch.Tensor: ...


class RuntimeModel(Protocol):
    """Samples (N, M) float32 actual runtimes around the EET rows."""

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


@dataclasses.dataclass(frozen=True)
class Scenario:
    """arrivals x mix x deadline x runtime — one workload recipe."""

    arrivals: ArrivalProcess
    mix: TypeMix
    deadline: DeadlineModel
    runtime: RuntimeModel

    def sample_arrays(self, seed, n_tasks: int, rate: float, eet, *,
                      cv_run: float = 0.1, n_task_types=None):
        """Host arrays of one trace: (arrival f32, task_type int64,
        exec_actual f32). The rate only enters the arrival process, so
        one seed gives the same types and runtimes at every rate."""
        eet = np.asarray(eet, np.float32)
        S = eet.shape[0] if n_task_types is None else int(n_task_types)
        s_arr, s_type, s_exec = split_seed(seed, 3)
        arrival = self.arrivals.sample(np.random.default_rng(s_arr),
                                       n_tasks, rate)
        task_type = self.mix.sample(np.random.default_rng(s_type),
                                    n_tasks, S)
        exec_actual = self.runtime.sample(np.random.default_rng(s_exec),
                                          eet, task_type, cv_run)
        return arrival, task_type, exec_actual

    def _trace(self, arrival, task_type, exec_actual, eet, dev) -> Trace:
        arrival = torch.as_tensor(arrival, device=dev)
        # drawn as int64 (that draw fixes the stream), kept as int32
        task_type = torch.as_tensor(np.asarray(task_type, np.int32),
                                    device=dev)
        eet_t = torch.as_tensor(np.asarray(eet, np.float32), device=dev)
        return Trace(arrival, task_type,
                     self.deadline.deadlines(arrival, task_type, eet_t),
                     torch.as_tensor(exec_actual, device=dev))

    def sample_trace(self, seed, n_tasks: int, rate: float, eet, *,
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
        random numbers). Leaves carry leading dims (R, K).
        """
        dev = resolve_device(device)
        rep_seeds = split_seed(seed, reps)
        cols = [np.stack(col) for col in zip(*(
            self.sample_arrays(s, n_tasks, float(rate), eet, cv_run=cv_run,
                               n_task_types=n_task_types)
            for rate in rates for s in rep_seeds))]
        R = len(rates)
        cols = [c.reshape((R, reps) + c.shape[1:]) for c in cols]
        return self._trace(*cols, eet, dev)
