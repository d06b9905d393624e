"""The comparison that decides ``correct``.

Two kinds of numbers, each with its limit:

* ``invariant_violations``: over every replicate of every batch in the
  window, those whose counters break conservation (completed + missed +
  cancelled = arrived, for every type) or whose arrivals do not sum to
  the trace's task count, or whose energies or makespan are not finite
  and non-negative. Limit 0.
* On a sample of the window's replicates drawn from the seed, the plain
  reference (``portbench/reference``) run on the same traces and the
  same tables:
  ``counter_mismatch``, the replicates whose per-type counters or
  makespan differ from the reference's (limit 0: the decisions are
  float32 on both sides, trace times dyadic), and ``energy_gap``, the
  widest gap of a dynamic, wasted or idle energy from the reference's,
  over the replicate's total energy (the program accumulates float32,
  the reference float64). The sample is spread over the row range: at
  each rate, one replicate from each of ``per_rate`` equal blocks of
  its replicates, so the last block always has one, each taken from a
  batch of the window drawn from the seed.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import sim

COUNTERS = ("completed_by_type", "missed_by_type", "cancelled_by_type",
            "arrived_by_type")
ENERGIES = ("energy_dynamic", "energy_wasted", "energy_idle")

LIMITS = {"invariant_violations": 0, "counter_mismatch": 0,
          "energy_gap": 1e-3}


def invariant_violations(m: dict, n_tasks: int) -> int:
    """Replicates of a batch's metrics (leaves (B, ...)) that break an
    invariant."""
    c, mi, ca, a = (np.asarray(m[k]) for k in COUNTERS)
    bad = (c + mi + ca != a).any(axis=-1) | (a.sum(axis=-1) != n_tasks)
    for k in ENERGIES + ("makespan",):
        v = np.asarray(m[k], np.float64)
        bad |= ~np.isfinite(v) | (v < 0)
    return int(bad.sum())


def candidates(seed: int, batch: int, n_rates: int, reps: int,
               per_rate: int) -> np.ndarray:
    """The rows of batch ``batch`` that may be checked, one per slot: slot
    ``r * per_rate + j`` is a replicate drawn from the seed out of block
    ``j`` of ``per_rate`` equal blocks of rate ``r``'s replicates (row =
    rate * reps + replicate)."""
    rng = np.random.default_rng([int(seed) % 2**64, int(batch), 1])
    take = min(per_rate, reps)
    edges = np.arange(take + 1) * reps // take
    drawn = rng.integers(edges[:-1], edges[1:], size=(n_rates, take))
    return (np.arange(n_rates)[:, None] * reps + drawn).ravel()


def pick(seed: int, n_batches: int, n_slots: int) -> np.ndarray:
    """For each slot of :func:`candidates`, the window batch whose row is
    checked, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    return rng.integers(0, n_batches, n_slots)


def gaps(port: dict, ref: dict) -> tuple:
    """``(counters or makespan differ, widest energy gap)`` of one
    replicate."""
    differ = any(not np.array_equal(np.asarray(port[k]), ref[k])
                 for k in COUNTERS)
    differ |= float(port["makespan"]) != ref["makespan"]
    total = abs(ref["energy_dynamic"]) + abs(ref["energy_idle"])
    gap = max(abs(float(port[k]) - ref[k]) for k in ENERGIES) / max(
        total, 1e-30)
    return bool(differ), float(gap)


def check_sample(rows: list, system: "sim.System", policy: str,
                 dispatcher: str) -> list:
    """Run the reference over ``rows``, each ``(trace, port metrics)``;
    return each row's :func:`gaps`."""
    return [gaps(port, sim.simulate(trace, system, policy, dispatcher))
            for trace, port in rows]


def summarize(results: list) -> dict:
    """The sample's numbers from :func:`check_sample`'s rows."""
    return {"counter_mismatch": sum(d for d, _ in results),
            "energy_gap": max((g for _, g in results), default=0.0)}


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    return all(v <= limits[k] for k, v in values.items()), checks
