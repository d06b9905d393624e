"""Batched Monte-Carlo sweeps (counterpart of ``repro/experiments``)."""
from repro_torch.experiments.results import SweepResult
from repro_torch.experiments.runner import run_sweep, simulate_sweep
from repro_torch.experiments.spec import (
    DEFAULT_HEURISTICS,
    DEFAULT_RATES,
    SweepSpec,
    parse_rates,
    replace,
)

__all__ = ["DEFAULT_HEURISTICS", "DEFAULT_RATES", "SweepResult",
           "SweepSpec", "parse_rates", "replace", "run_sweep",
           "simulate_sweep"]
