"""Workload trace synthesis (counterpart of ``repro/core/workload.py``):
a thin wrapper over the default scenario."""
from __future__ import annotations

import warnings

from repro_torch.core.types import Trace


def poisson_trace(seed, n_tasks, arrival_rate, eet, *, n_task_types=None,
                  cv_run=0.1, type_probs=None, device=None) -> Trace:
    """One trace under the paper's default scenario: Exp(rate)
    inter-arrivals, uniform types (or per ``type_probs``, a
    ``WeightedMix``), Eq. 4 deadlines, Gamma runtimes. ``seed`` is an int
    or a ``numpy.random.SeedSequence``."""
    from repro_torch import scenarios

    scenario = scenarios.DEFAULT
    if type_probs is not None:
        scenario = scenarios.replace(
            scenario, mix=scenarios.mix_from_probs(tuple(type_probs)))
    return scenario.sample_trace(
        seed, n_tasks, arrival_rate, eet, cv_run=cv_run,
        n_task_types=n_task_types, device=device)


def trace_batch(seed, n_traces, n_tasks, arrival_rate, eet, **kw) -> Trace:
    """Deprecated: a batch of i.i.d. traces (stacked leading dim).

    .. deprecated::
        ``trace_batch(seed, K, ...)`` is exactly
        ``trace_stack(seed, rates=(rate,), reps=K, ...)`` with the
        single-rate axis squeezed. Call
        :func:`repro_torch.datapipe.synthetic.trace_stack` (or
        ``Scenario.stack``) directly.
    """
    warnings.warn(
        "workload.trace_batch is deprecated; use "
        "repro_torch.datapipe.synthetic.trace_stack (rates=(rate,), "
        "reps=n_traces) or Scenario.stack instead",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.datapipe import synthetic

    stacked = synthetic.trace_stack(
        seed, (arrival_rate,), n_traces, n_tasks, eet, **kw)
    return Trace(*(x[0] for x in stacked))
