"""The port's engine on the synthetic fleets and the scenarios that bring
their own fleet, against the JAX engine.

The reference's scenario traces (dyadic-rounded, as its tests round
them) and its built fleet arrays go through both engines: counters,
makespans and every energy bit for bit (at most 8 machines, where the
port sums as the reference's compiled code does), on the plain path and
the fused one (the kernels' plain versions on the CPU). The shapes are
the ones these fleets give the scheduling kernels: 8 types on 6 machines
(``cvb``), 6 on 6 (``range``, an Eq. 3 sigma over 6 types), 7 machines in
unequal sites of 4 and 3 (``mixed_sites``, the masked fold), and
``paper_x2`` under a skewed type mix (``federated-skew``, the block fold).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import dispatch as jdispatch
from repro.core import engine as jengine
from repro.core import equations as jeq
from repro.core.types import Trace as JTrace
from repro_torch import interop, scenarios
from repro_torch.core import dispatch
from repro_torch.core import engine as tengine
from repro_torch.core import equations as teq
from test_torch_common import (
    CPU,
    assert_metrics_match,
    dyadic,
    port_spec,
)

# case: (fleet, scenario of the traces, total rate, heuristic, dispatcher)
CASES = {
    "cvb-FELARE": ("cvb", "wide-fleet", 4.0, "FELARE", None),
    "cvb-ELARE": ("cvb", "wide-fleet", 4.0, "ELARE", None),
    "range-FELARE": ("range", "heavy-tail", 3.5, "FELARE", None),
    "mixed_sites-least_queued": ("mixed_sites", "flash-crowd", 4.0,
                                 "FELARE", "least_queued"),
    "mixed_sites-min_eet": ("mixed_sites", "flash-crowd", 4.0, "FELARE",
                            "min_eet"),
    "federated-skew-sticky_by_type": ("paper_x2", "federated-skew", 6.0,
                                      "FELARE", "sticky_by_type"),
    "federated-skew-fair_spill": ("paper_x2", "federated-skew", 6.0,
                                  "FELARE", "fair_spill"),
}
REPS, TASKS = 3, 90


def _dispatchers(name):
    """(reference, port) dispatcher of a case."""
    if name == "sticky_by_type":
        return jdispatch.Sticky(by_type=True), dispatch.Sticky(by_type=True)
    return name, name


@functools.lru_cache(maxsize=None)
def _traces(fleet: str, scenario: str, rate: float):
    """The reference's fleet and its flat batch of dyadic traces."""
    spec = jscenarios.get_fleet(fleet).build()
    st = jscenarios.get(scenario).stack(jax.random.PRNGKey(11), (rate,),
                                        REPS, TASKS, spec.eet)
    flat = [np.asarray(x).reshape((REPS,) + np.shape(x)[2:]) for x in st]
    arrival, task_type, deadline, exec_actual = flat
    return spec, (dyadic(arrival), task_type, dyadic(deadline),
                  dyadic(exec_actual))


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    fleet, scenario, rate, heuristic, disp = CASES[case]
    spec, arrays = _traces(fleet, scenario, rate)
    m = jengine.simulate_batch(JTrace(*arrays), spec, heuristic,
                               dispatcher=_dispatchers(disp)[0])
    return {k: np.asarray(v) for k, v in m._asdict().items()}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_on_scenario_fleets(case, fused):
    fleet, scenario, rate, heuristic, disp = CASES[case]
    spec, arrays = _traces(fleet, scenario, rate)
    traces = interop.trace_from_arrays(*arrays, device=CPU)
    got = interop.metrics_to_numpy(tengine.simulate_batch(
        traces, port_spec(spec), heuristic,
        dispatcher=_dispatchers(disp)[1], use_fused_map=fused,
        use_fused_phase1=fused and heuristic == "ELARE", device=CPU))
    ref = _reference(case)
    for i in range(REPS):
        assert_metrics_match({k: v[i] for k, v in ref.items()},
                             {k: v[i] for k, v in got.items()},
                             f"{case} replicate {i}", energy_rel=0,
                             n_machines=spec.n_machines)
    # the traces load the fleet: tasks are dropped and all types arrive
    assert ref["completed_by_type"].sum() < ref["arrived_by_type"].sum()
    assert np.all(ref["arrived_by_type"].sum(0) > 0)


def test_registered_fleet_builds_feed_the_engine_unchanged():
    """The port's own registered builds are the arrays the test runs on."""
    for fleet in ("cvb", "range", "mixed_sites", "paper_x2"):
        got = scenarios.get_fleet(fleet).build()
        want = port_spec(jscenarios.get_fleet(fleet).build())
        for field in ("eet", "p_dyn", "p_idle"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.site_of_machine == want.site_of_machine


@pytest.mark.parametrize("S", [3, 5, 6, 7, 8, 12])
def test_fairness_limit_bit_for_bit_at_any_type_count(S):
    """Eq. 3 (mu - f sigma) equals the reference's compiled, batched form
    at type counts that are not powers of two (``range`` has 6)."""
    r = np.random.default_rng(S)
    cr = np.clip(r.integers(0, 300, (20000, S))
                 / r.integers(1, 300, (20000, S)), 0, 1).astype(np.float32)
    for f in (1.0, 0.7):
        want = np.asarray(jax.jit(jax.vmap(
            lambda c: jeq.fairness_limit(c, f)))(cr))
        got = teq.fairness_limit(torch.from_numpy(cr), f).numpy()
        np.testing.assert_array_equal(got, want)
