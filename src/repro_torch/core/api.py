"""High-level experiment API (counterpart of ``repro/core/api.py``).

  * :func:`paper_system` / :func:`aws_system` build the two evaluation
    systems of Sec. VI-A;
  * :func:`run_study` runs the paper's experiment template (K traces per
    arrival rate, one heuristic) through
    :func:`repro_torch.experiments.run_sweep`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import eet as eet_mod
from repro_torch.core.types import SystemSpec


def paper_system(queue_size: int = 2, fairness_factor: float = 1.0
                 ) -> SystemSpec:
    """The synthetic 4x4 system of Sec. VI-A (Table I + power profile)."""
    return SystemSpec(eet=eet_mod.TABLE_I, p_dyn=eet_mod.P_DYN,
                      p_idle=eet_mod.P_IDLE, queue_size=queue_size,
                      fairness_factor=fairness_factor)


def aws_system(queue_size: int = 2, fairness_factor: float = 1.0
               ) -> SystemSpec:
    """The AWS scenario: t2.xlarge / g3s.xlarge running FaceNet /
    DeepSpeech."""
    return SystemSpec(eet=eet_mod.AWS_EET, p_dyn=eet_mod.AWS_P_DYN,
                      p_idle=eet_mod.AWS_P_IDLE, queue_size=queue_size,
                      fairness_factor=fairness_factor)


@dataclasses.dataclass
class StudyResult:
    """One (heuristic, arrival-rate) cell of a study.

    ``metrics`` holds per-replicate numpy arrays under the Metrics field
    names: counts (K, S), energies and makespan (K,). ``aux`` holds the
    attached observers' results for this cell (leaves leading with K),
    or ``None`` when none was attached.
    """

    heuristic: str
    arrival_rate: float
    metrics: object
    p_dyn: np.ndarray = dataclasses.field(repr=False)
    aux: object = dataclasses.field(default=None, repr=False)

    @property
    def completion_rate(self) -> float:
        """On-time completion rate pooled over replicates and types."""
        m = self.metrics
        return float(np.sum(m.completed_by_type)
                     / np.maximum(np.sum(m.arrived_by_type), 1))

    @property
    def miss_rate(self) -> float:
        return 1.0 - self.completion_rate

    @property
    def completion_rate_by_type(self) -> np.ndarray:
        """(S,) per-task-type completion rates, pooled over replicates."""
        m = self.metrics
        # repro: allow-f64[a host-side summary of the finished counts]
        c = np.asarray(m.completed_by_type, np.float64).sum(0)
        # repro: allow-f64[the same summary]
        a = np.asarray(m.arrived_by_type, np.float64).sum(0)
        return c / np.maximum(a, 1)

    @property
    def energy_total(self) -> float:
        """Mean (dynamic + idle) energy per trace."""
        m = self.metrics
        return float(np.mean(np.asarray(m.energy_dynamic)
                             + np.asarray(m.energy_idle)))

    @property
    def wasted_energy_pct(self) -> float:
        """Wasted dynamic energy as % of the normalized battery capacity
        (mean makespan x total dynamic power, Sec. VII-B)."""
        m = self.metrics
        cap = np.mean(np.asarray(m.makespan)) * float(np.sum(self.p_dyn))
        return float(np.mean(np.asarray(m.energy_wasted))) / max(cap, 1e-9) \
            * 100


def run_study(heuristic: str, arrival_rates, spec: SystemSpec, *,
              n_traces: int = 30, n_tasks: int = 2000, seed: int = 0,
              cv_run: float = 0.1, scenario="poisson", observers=(),
              use_fused_map: bool = False, use_fused_phase1: bool = False,
              dispatcher="sticky", dynamics="none", network="none",
              device=None):
    """The paper's experiment template for one heuristic: ``n_traces``
    replicate traces per rate under one seed (common random numbers
    across rates), simulated as one batch on ``device`` (``None`` =
    CUDA).

    ``scenario`` is the workload (a registered name or a Scenario; the
    paper's Poisson workload by default), ``observers`` the engine
    observers to attach (names or Observer instances; their per-cell
    results land on :attr:`StudyResult.aux`). A federated ``spec``
    dispatches through ``dispatcher``; ``dynamics`` (a registered name or
    a MachineDynamics; ``"none"`` = no faults) injects machine failures;
    ``network`` (a registered name or a NetworkModel; ``"none"`` = free
    links) prices inter-site dispatch over the spec's tiers. Returns one
    :class:`StudyResult` per rate, in ``arrival_rates`` order."""
    from repro_torch import experiments

    sweep_spec = experiments.SweepSpec(
        system=spec, scenario=scenario,
        rates=tuple(float(r) for r in arrival_rates),
        reps=n_traces, n_tasks=n_tasks, heuristics=(heuristic,), seed=seed,
        cv_run=cv_run, observers=tuple(observers),
        use_fused_map=use_fused_map, use_fused_phase1=use_fused_phase1,
        dispatcher=dispatcher, dynamics=dynamics, network=network,
    )
    result = experiments.run_sweep(sweep_spec, device=device)

    def cell_aux(r_i):
        if not result.aux:
            return None

        def take(x):
            if isinstance(x, dict):
                return {k: take(v) for k, v in x.items()}
            return x[0, r_i]

        return take(result.aux)

    return [
        StudyResult(heuristic, float(rate),
                    result.metrics_for(heuristic, rate),
                    p_dyn=np.asarray(spec.p_dyn), aux=cell_aux(r_i))
        for r_i, rate in enumerate(sweep_spec.rates)
    ]
