"""Workload trace synthesis (counterpart of ``repro/core/workload.py``):
a thin wrapper over the default scenario."""
from __future__ import annotations

from repro_torch.core.types import Trace


def poisson_trace(seed, n_tasks, arrival_rate, eet, *, n_task_types=None,
                  cv_run=0.1, device=None) -> Trace:
    """One trace under the paper's default scenario: Exp(rate)
    inter-arrivals, uniform types, Eq. 4 deadlines, Gamma runtimes.
    ``seed`` is an int or a ``numpy.random.SeedSequence``."""
    from repro_torch import scenarios

    return scenarios.DEFAULT.sample_trace(
        seed, n_tasks, arrival_rate, eet, cv_run=cv_run,
        n_task_types=n_task_types, device=device)
