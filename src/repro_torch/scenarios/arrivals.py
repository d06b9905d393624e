"""Arrival processes (counterpart of ``repro/scenarios/arrivals.py``).

Every process turns unit-rate draws into ``(N,)`` sorted, non-negative
float32 arrival times whose nominal rate is ``rate`` tasks/s: a Poisson
stream ``cumsum(Exp(1))`` mapped through the inverse of the integrated
rate, in closed form or by a fixed number of Newton steps. Non-stationary
structure (burst dwell, diurnal period, spike window) is set in fractions
of the nominal horizon ``n_tasks / rate``, so a scenario means the same
at every rate.

Each process is a draw (numpy, per trace) and a transform (float32, the
reference's arithmetic op for op, over any leading dims); see
:mod:`repro_torch.scenarios.base`. The transforms of the Poisson, MMPP
and flash-crowd processes give the reference's arrivals bit for bit from
its own draws; the diurnal one runs float32 ``sin`` and ``cos``, which
numpy and XLA round differently in the last place.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

from repro_torch.core.equations import cumsum32
from repro_torch.scenarios.base import as_rate, component

_NEWTON_ITERS = 20  # fixed-count inversion of the integrated rate
F32 = np.float32


class _Process:
    """``sample`` is the transform of the draw."""

    def sample(self, rng: np.random.Generator, n_tasks: int,
               rate) -> np.ndarray:
        return self.transform(self.draw(rng, n_tasks), rate)


class _UnitStream(_Process):
    """The processes that draw only Exp(1) gaps."""

    def draw(self, rng: np.random.Generator, n_tasks: int) -> tuple:
        return (rng.standard_exponential(n_tasks, dtype=F32),)


@component("arrivals")
@dataclasses.dataclass(frozen=True)
class PoissonArrivals(_UnitStream):
    """Stationary Poisson arrivals (the paper's Sec. VI-A workload):
    Exp(1) gaps divided by the rate, accumulated in float32."""

    kind: ClassVar[str] = "poisson"

    def transform(self, draws: tuple, rate) -> np.ndarray:
        (e,) = draws
        return cumsum32(e / as_rate(rate))


@component("arrivals")
@dataclasses.dataclass(frozen=True)
class MMPPArrivals(_Process):
    """Bursty 2-phase Markov-modulated Poisson process (on-off).

    A sticky two-state chain over arrivals switches between a quiet phase
    and a burst phase ``rate_ratio`` x faster; the phase rates are
    normalized so that the long-run mean rate is the nominal one.
    ``p_stay`` sets the dwell (``1 / (1 - p_stay)`` arrivals per burst),
    ``burst_frac`` the stationary share of arrivals in the burst phase.
    """

    kind: ClassVar[str] = "mmpp"
    rate_ratio: float = 8.0
    p_stay: float = 0.95
    burst_frac: float = 0.3

    def __post_init__(self):
        if not self.rate_ratio > 1.0:
            raise ValueError("rate_ratio must be > 1 (burst faster than quiet)")
        if not 0.0 < self.burst_frac < 1.0:
            raise ValueError("burst_frac must be in (0, 1)")
        if not 0.0 <= self.p_stay < 1.0:
            raise ValueError("p_stay must be in [0, 1)")
        # Detailed balance fixes the quiet phase's exit probability; above
        # 1 the chain cannot hold the assumed stationary distribution.
        q_qb = (1.0 - self.p_stay) * self.burst_frac / (1.0 - self.burst_frac)
        if q_qb > 1.0:
            raise ValueError(
                f"infeasible MMPP: quiet-phase exit probability "
                f"(1 - p_stay) * burst_frac / (1 - burst_frac) = "
                f"{q_qb:.3f} > 1; increase p_stay or lower burst_frac")

    def draw(self, rng: np.random.Generator, n_tasks: int) -> tuple:
        """Exp(1) gaps, the chain's (N,) uniforms, its initial uniform."""
        return (rng.standard_exponential(n_tasks, dtype=F32),
                rng.random(n_tasks, dtype=F32), rng.random(dtype=F32))

    def burst_phase(self, u, init_u) -> np.ndarray:
        """The chain's phase after each arrival's switch draw (True =
        burst), over any leading dims of ``u`` at once: it depends on the
        draws alone, not on the rate."""
        q_bq = 1.0 - self.p_stay
        q_qb = q_bq * self.burst_frac / (1.0 - self.burst_frac)
        leave_burst = u < F32(q_bq)
        leave_quiet = u < F32(q_qb)
        burst = np.asarray(init_u) < F32(self.burst_frac)
        out = np.empty(u.shape, bool)
        for k in range(u.shape[-1]):
            burst = burst ^ np.where(burst, leave_burst[..., k],
                                     leave_quiet[..., k])
            out[..., k] = burst
        return out

    def transform(self, draws: tuple, rate) -> np.ndarray:
        e, u, init_u = draws
        burst = self.burst_phase(u, init_u)
        pi_b = self.burst_frac
        # quiet rate such that E[gap] = pi_q / r_q + pi_b / r_b = 1 / rate
        r_quiet = as_rate(rate) * F32((1.0 - pi_b) + pi_b / self.rate_ratio)
        rate_k = np.where(burst, F32(self.rate_ratio) * r_quiet, r_quiet)
        return cumsum32(e / rate_k)


@component("arrivals")
@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(_UnitStream):
    """Sinusoidal-rate arrivals: lambda(t) = rate (1 + a sin(2 pi t / P)).

    The period spans ``1 / cycles`` of the nominal horizon. A unit-rate
    stream goes through the inverse of the integrated rate by 20 Newton
    steps, then a running maximum restores monotonicity against the last
    float32 ulp of Newton residue.
    """

    kind: ClassVar[str] = "diurnal"
    amplitude: float = 0.8
    cycles: float = 4.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1) so lambda(t) > 0")
        if not self.cycles > 0:
            raise ValueError("cycles must be positive")

    def transform(self, draws: tuple, rate) -> np.ndarray:
        (e,) = draws
        gam = cumsum32(e)
        rate = as_rate(rate)
        a = F32(self.amplitude)
        period = F32(e.shape[-1]) / (rate * F32(self.cycles))
        w = F32(2.0 * np.pi) / period
        arc = rate * a / w
        t = gam / rate  # stationary-Poisson initial guess
        for _ in range(_NEWTON_ITERS):
            wt = w * t
            big = rate * t + arc * (F32(1) - np.cos(wt))
            small = rate * (F32(1) + a * np.sin(wt))
            t = t - (big - gam) / small
        return np.maximum.accumulate(np.maximum(t, F32(0)), axis=-1)


@component("arrivals")
@dataclasses.dataclass(frozen=True)
class FlashCrowdArrivals(_UnitStream):
    """Baseline Poisson with a flash-crowd spike window.

    The rate is ``spike_mult x rate`` inside ``[spike_start, spike_start +
    spike_frac]`` (fractions of the nominal horizon) and ``rate``
    elsewhere; the piecewise-linear integrated rate inverts in closed
    form.
    """

    kind: ClassVar[str] = "flash-crowd"
    spike_start: float = 0.4
    spike_frac: float = 0.15
    spike_mult: float = 6.0

    def __post_init__(self):
        if not 0.0 <= self.spike_start < 1.0:
            raise ValueError("spike_start must be in [0, 1)")
        if not self.spike_frac > 0:
            raise ValueError("spike_frac must be positive")
        if not self.spike_mult >= 1.0:
            raise ValueError("spike_mult must be >= 1")

    def transform(self, draws: tuple, rate) -> np.ndarray:
        (e,) = draws
        gam = cumsum32(e)
        rate = as_rate(rate)
        horizon = F32(e.shape[-1]) / rate
        t0 = F32(self.spike_start) * horizon
        dur = F32(self.spike_frac) * horizon
        fast = rate * F32(self.spike_mult)
        g0 = rate * t0                      # integrated rate before the spike
        g1 = g0 + fast * dur                # ... and through it
        t_in = t0 + (gam - g0) / fast
        t_post = (t0 + dur) + (gam - g1) / rate
        return np.where(gam <= g0, gam / rate,
                        np.where(gam <= g1, t_in, t_post))
