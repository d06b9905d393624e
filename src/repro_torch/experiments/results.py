"""Sweep result container (counterpart of ``repro/experiments/results.py``).

The raw material is a Metrics record of numpy arrays whose leaves carry
(H, R, K, ...) leading dims — H heuristics, R arrival rates, K replicate
traces. :class:`SweepResult` reduces it to what the paper plots: on-time
completion rate, total and wasted energy, per-type fairness, each with a
mean and a 95% normal CI over the replicates, and writes ``sweep.csv``
and ``sweep.json``; with observers attached, also ``observers.json`` and,
for ``timeline``, ``timeline.csv``.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import pathlib

import numpy as np

from repro_torch.core.types import Metrics, SystemSpec

_Z95 = 1.96


def _mean_ci(x: np.ndarray, axis: int = -1):
    """Mean and 95% normal CI half-width over ``axis`` (K replicates)."""
    x = np.asarray(x, np.float64)
    k = x.shape[axis]
    mean = x.mean(axis=axis)
    if k < 2:
        return mean, np.zeros_like(mean)
    return mean, _Z95 * x.std(axis=axis, ddof=1) / np.sqrt(k)


def _jain(values: np.ndarray, axis: int = -1):
    """Jain's fairness index along ``axis`` (1.0 = perfectly fair)."""
    v = np.asarray(values, np.float64)
    s1 = v.sum(axis=axis)
    s2 = (v * v).sum(axis=axis)
    n = v.shape[axis]
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(s2 > 0, s1 * s1 / (n * s2), 1.0)


@dataclasses.dataclass
class SweepResult:
    """Everything a sweep produced, reduced and raw.

    ``metrics`` leaves are numpy arrays: counts (H, R, K, S), energies
    and makespan (H, R, K). ``aux`` maps each attached observer's name to
    its result, every leaf a numpy array leading with (H, R, K); ``{}``
    when none was attached. ``device`` names where the sweep ran, and
    ``run_info`` holds per heuristic the wall seconds, the batched
    loop iterations and the scenario's label.
    """

    spec: object
    system: SystemSpec
    heuristics: tuple[str, ...]
    rates: tuple[float, ...]
    metrics: Metrics
    aux: dict = dataclasses.field(default_factory=dict, repr=False)
    device: str = ""
    run_info: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_metrics(cls, spec, system: SystemSpec, metrics: Metrics, *,
                     aux=None, device: str = "",
                     run_info=None) -> "SweepResult":
        metrics = Metrics(*(np.asarray(leaf) for leaf in metrics))
        return cls(spec=spec, system=system,
                   heuristics=tuple(spec.heuristics),
                   rates=tuple(spec.rates), metrics=metrics,
                   aux=dict(aux or {}), device=device,
                   run_info=dict(run_info or {}))

    # ---------------------------------------------------------------- axes
    def h_index(self, heuristic: str) -> int:
        return self.heuristics.index(heuristic.upper())

    def r_index(self, rate: float) -> int:
        for i, x in enumerate(self.rates):
            if abs(x - float(rate)) < 1e-9:
                return i
        raise ValueError(f"rate {rate!r} not in sweep grid {self.rates}")

    # ------------------------------------------------------- per-trace stats
    @property
    def completion_rate_traces(self) -> np.ndarray:
        """(H, R, K) on-time completion rate of each simulated trace."""
        c = self.metrics.completed_by_type.sum(-1).astype(np.float64)
        a = self.metrics.arrived_by_type.sum(-1).astype(np.float64)
        return c / np.maximum(a, 1.0)

    @property
    def energy_traces(self) -> np.ndarray:
        """(H, R, K) total (dynamic + idle) energy of each trace."""
        return (np.asarray(self.metrics.energy_dynamic, np.float64)
                + np.asarray(self.metrics.energy_idle, np.float64))

    @property
    def wasted_pct_traces(self) -> np.ndarray:
        """(H, R, K) wasted dynamic energy as % of the normalized battery
        (mean makespan of the cell x total dynamic power, Sec. VII-B)."""
        cap = (self.metrics.makespan.mean(-1, keepdims=True)
               * float(np.sum(self.system.p_dyn)))
        return (np.asarray(self.metrics.energy_wasted, np.float64)
                / np.maximum(cap, 1e-9) * 100.0)

    # ------------------------------------------------------- cell summaries
    @property
    def completion_rate(self) -> np.ndarray:
        """(H, R) mean on-time completion rate over replicates."""
        return _mean_ci(self.completion_rate_traces)[0]

    @property
    def completion_rate_pooled(self) -> np.ndarray:
        """(H, R) completion rate pooled over replicates and types: total
        completions over total arrivals (replicates weighted by their
        arrivals); :attr:`completion_rate` averages per-trace rates."""
        c = self.metrics.completed_by_type.sum(-1).sum(-1).astype(np.float64)
        a = self.metrics.arrived_by_type.sum(-1).sum(-1).astype(np.float64)
        return c / np.maximum(a, 1.0)

    @property
    def energy(self) -> np.ndarray:
        """(H, R) mean total energy."""
        return _mean_ci(self.energy_traces)[0]

    @property
    def wasted_pct(self) -> np.ndarray:
        """(H, R) mean wasted-energy percentage."""
        return _mean_ci(self.wasted_pct_traces)[0]

    def _pooled_pct(self, counts) -> np.ndarray:
        c = counts.sum(-1).sum(-1).astype(np.float64)
        a = self.metrics.arrived_by_type.sum(-1).sum(-1).astype(np.float64)
        return c / np.maximum(a, 1.0) * 100.0

    @property
    def cancelled_pct(self) -> np.ndarray:
        """(H, R) cancelled tasks as % of arrivals (pooled over reps)."""
        return self._pooled_pct(self.metrics.cancelled_by_type)

    @property
    def missed_pct(self) -> np.ndarray:
        """(H, R) deadline-missed tasks as % of arrivals (pooled)."""
        return self._pooled_pct(self.metrics.missed_by_type)

    @property
    def completion_rate_by_type(self) -> np.ndarray:
        """(H, R, S) per-type completion rates, pooled over replicates."""
        c = self.metrics.completed_by_type.sum(2).astype(np.float64)
        a = self.metrics.arrived_by_type.sum(2).astype(np.float64)
        return c / np.maximum(a, 1.0)

    @property
    def worst_type_rate(self) -> np.ndarray:
        """(H, R) completion rate of the worst-served task type."""
        return self.completion_rate_by_type.min(-1)

    @property
    def fairness_spread(self) -> np.ndarray:
        """(H, R) std of per-type completion rates (lower = fairer)."""
        return self.completion_rate_by_type.std(-1)

    @property
    def jain_index(self) -> np.ndarray:
        """(H, R) Jain's fairness index over per-type rates (1 = fair)."""
        return _jain(self.completion_rate_by_type)

    def metrics_for(self, heuristic: str, rate: float) -> Metrics:
        """The raw per-trace Metrics of one (heuristic, rate) cell."""
        h, r = self.h_index(heuristic), self.r_index(rate)
        return Metrics(*(leaf[h, r] for leaf in self.metrics))

    # ------------------------------------------------------------ artifacts
    def summary_rows(self) -> list[dict]:
        """One CSV-ready dict per (heuristic, rate) cell."""
        cr, cr_ci = _mean_ci(self.completion_rate_traces)
        en, en_ci = _mean_ci(self.energy_traces)
        wp, wp_ci = _mean_ci(self.wasted_pct_traces)
        by_type = self.completion_rate_by_type
        spread, jain = self.fairness_spread, self.jain_index
        cpct, mpct = self.cancelled_pct, self.missed_pct
        rows = []
        for h_i, h in enumerate(self.heuristics):
            for r_i, rate in enumerate(self.rates):
                row = {
                    "heuristic": h,
                    "rate": rate,
                    "reps": self.metrics.makespan.shape[2],
                    "completion_rate": round(float(cr[h_i, r_i]), 6),
                    "completion_rate_ci95": round(float(cr_ci[h_i, r_i]), 6),
                    "energy": round(float(en[h_i, r_i]), 3),
                    "energy_ci95": round(float(en_ci[h_i, r_i]), 3),
                    "wasted_pct": round(float(wp[h_i, r_i]), 4),
                    "wasted_pct_ci95": round(float(wp_ci[h_i, r_i]), 4),
                    "cancelled_pct": round(float(cpct[h_i, r_i]), 4),
                    "missed_pct": round(float(mpct[h_i, r_i]), 4),
                    "fairness_spread": round(float(spread[h_i, r_i]), 6),
                    "jain_index": round(float(jain[h_i, r_i]), 6),
                }
                for s in range(by_type.shape[-1]):
                    row[f"completion_rate_T{s + 1}"] = round(
                        float(by_type[h_i, r_i, s]), 6)
                rows.append(row)
        return rows

    def to_json_dict(self) -> dict:
        return {
            "spec": self.spec.to_json_dict(),
            "device": self.device,
            "heuristics": list(self.heuristics),
            "rates": list(self.rates),
            "summary": self.summary_rows(),
        }

    # -------------------------------------------------- time-series views
    def timeline_rows(self) -> list[dict]:
        """Long-form CSV rows of the ``timeline`` observer's series.

        One row per (heuristic, rate, replicate, bucket) with the sampled
        queue occupancy, cumulative energies and per-type completions.
        Raises KeyError if the sweep did not attach the observer.
        """
        tl = self.aux["timeline"]
        H, R, K, B = tl["e_dyn"].shape
        S = tl["completed"].shape[-1]
        rows = []
        for h_i, h in enumerate(self.heuristics):
            for r_i, rate in enumerate(self.rates):
                for k in range(K):
                    for b in range(B):
                        row = {
                            "heuristic": h,
                            "rate": rate,
                            "rep": k,
                            "bucket": b,
                            "t": round(float(tl["t"][h_i, r_i, k, b]), 6),
                            "qlen": int(tl["qlen"][h_i, r_i, k, b]),
                            "running": int(tl["running"][h_i, r_i, k, b]),
                            "energy_dynamic": round(
                                float(tl["e_dyn"][h_i, r_i, k, b]), 4),
                            "energy_idle": round(
                                float(tl["e_idle"][h_i, r_i, k, b]), 4),
                        }
                        for s in range(S):
                            row[f"completed_T{s + 1}"] = int(
                                tl["completed"][h_i, r_i, k, b, s])
                        rows.append(row)
        return rows

    def aux_json_dict(self) -> dict:
        """Every observer's stacked aux as JSON-ready nested lists.

        Non-finite floats (an unexhausted budget's ``t_exhausted=inf``)
        become ``null``: strict RFC 8259 JSON.
        """
        def scrub(v):
            if isinstance(v, list):
                return [scrub(i) for i in v]
            if isinstance(v, float) and not np.isfinite(v):
                return None
            return v

        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            return scrub(np.asarray(x).tolist())

        return conv(self.aux)

    def save(self, outdir) -> dict[str, pathlib.Path]:
        """Write ``sweep.csv`` + ``sweep.json`` under ``outdir``, and with
        observers attached ``observers.json`` (all observers, nested
        lists) and, if ``timeline`` ran, a long-form ``timeline.csv``.
        Returns the written paths keyed by format."""
        outdir = pathlib.Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        rows = self.summary_rows()
        csv_path = outdir / "sweep.csv"
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
        json_path = outdir / "sweep.json"
        with open(json_path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2)
        paths = {"csv": csv_path, "json": json_path}
        if self.aux:
            obs_path = outdir / "observers.json"
            with open(obs_path, "w") as f:
                json.dump(self.aux_json_dict(), f, allow_nan=False)
            paths["observers_json"] = obs_path
        if "timeline" in self.aux:
            trows = self.timeline_rows()
            tpath = outdir / "timeline.csv"
            with open(tpath, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(trows[0].keys()))
                writer.writeheader()
                writer.writerows(trows)
            paths["timeline_csv"] = tpath
        return paths
