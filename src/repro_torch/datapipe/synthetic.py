"""Batched scheduling-workload synthesis (counterpart of
``repro/datapipe/synthetic.py::trace_stack``)."""
from __future__ import annotations


def trace_stack(seed, rates, reps, n_tasks, eet, *, cv_run: float = 0.1,
                type_probs=None, scenario=None, n_task_types=None,
                device=None):
    """The (rates x replicates) grid of traces under one seed.

    Replicate ``k`` shares its draws across rates (common random
    numbers); only the arrival process sees the rate. ``scenario`` is a
    :class:`repro_torch.scenarios.Scenario`, a registered name, or
    ``None`` for the paper's Poisson default; ``type_probs`` (S,) swaps
    its mix for a ``WeightedMix``. Leaves carry leading dims (R, K) and
    lie on ``device`` (``None`` = CUDA).
    """
    from repro_torch import scenarios as scenarios_mod

    if scenario is None:
        scenario = scenarios_mod.DEFAULT
    elif isinstance(scenario, str):
        scenario = scenarios_mod.get(scenario)
    if type_probs is not None:
        scenario = scenarios_mod.replace(
            scenario, mix=scenarios_mod.mix_from_probs(tuple(type_probs)))
    return scenario.stack(seed, rates, reps, n_tasks, eet, cv_run=cv_run,
                          n_task_types=n_task_types, device=device)
