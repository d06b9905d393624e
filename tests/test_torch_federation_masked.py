"""Federation parity on the masked fold and the widest block fold: the
port's engine against the JAX engine and the pure-Python oracle
(``repro.core.pyengine``).

Sites that are not equal contiguous blocks fold into B * F views of all
M machines, the other sites' machines masked out, as the reference's
masked path does: an interleaved partition (0, 1, 0, 1) of the paper
system, the reference's ``mixed_sites`` fleet carried across as arrays
(its EET comes from the JAX PRNG, so the port has no builder of its
own), and ``tiered_x4`` (three device sites and a cloud site twice their
size). ``paper_x8`` runs the two combinations the JAX package checks
against the oracle at eight sites. On dyadic traces the per-type
counters, the makespan and every task's final site are identical,
energies within rel 1e-5, with and without ``use_fused_map``.

Also here: the site and tier partitions of ``SystemSpec`` and the
federated fleets.
"""
import functools

import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core.types import SystemSpec as JaxSpec
from repro_torch import interop, scenarios
from repro_torch.core.types import SystemSpec
from test_torch_common import (
    SPEC,
    TSPEC,
    assert_metrics_match,
    jax_federated,
    jax_trace,
    port_federated,
    port_spec,
    stack_traces,
)

torch.set_num_threads(1)

SEEDS = (0, 7)
INTERLEAVED = JaxSpec(eet=SPEC.eet, p_dyn=SPEC.p_dyn, p_idle=SPEC.p_idle,
                      queue_size=SPEC.queue_size,
                      fairness_factor=SPEC.fairness_factor,
                      site_of_machine=(0, 1, 0, 1))
# system: (reference spec, tasks, total rate)
SYSTEMS = {
    "interleaved": (lambda: INTERLEAVED, 64, 3.0),
    "mixed_sites": (lambda: jscenarios.get_fleet("mixed_sites").build(),
                    64, 4.0),
    "tiered_x4": (lambda: jscenarios.get_fleet("tiered_x4").build(), 64,
                  10.0),
    "paper_x8": (lambda: jscenarios.get_fleet("paper_x8").build(), 96, 8.0),
}
CASES = ([(s, h, d) for s in ("interleaved", "mixed_sites", "tiered_x4")
          for h, d in (("FELARE", "fair_spill"), ("ELARE", "least_queued"),
                       ("RANDOM", "round_robin"))]
         + [("paper_x8", "ELARE", "round_robin"),
            ("paper_x8", "FELARE", "fair_spill")])


@functools.lru_cache(maxsize=None)
def _system(name):
    build, n, rate = SYSTEMS[name]
    spec = build()
    return spec, tuple(jax_trace(s, n, rate, spec.eet) for s in SEEDS)


@functools.lru_cache(maxsize=None)
def _reference(name, heuristic, dispatcher):
    spec, traces = _system(name)
    return jax_federated(spec, traces, heuristic, dispatcher)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("system,heuristic,dispatcher", CASES)
def test_engine_matches_jax_and_oracle(system, heuristic, dispatcher,
                                       fused):
    spec, traces = _system(system)
    port, sites = port_federated(port_spec(spec), stack_traces(traces),
                                 heuristic, dispatcher, fused)
    jax_rows, _, oracle = _reference(system, heuristic, dispatcher)
    for i, seed in enumerate(SEEDS):
        row = {k: v[i] for k, v in port.items()}
        what = f"{system} {heuristic} {dispatcher} seed {seed}"
        assert_metrics_match(jax_rows[i], row, what + " jax",
                             n_machines=spec.n_machines)
        assert_metrics_match(oracle[i], row, what + " oracle")
        np.testing.assert_array_equal(sites[i], oracle[i]["task_log"]["site"],
                                      err_msg=what + " sites")


FLEETS = ("paper_x2", "paper_x4", "paper_x8", "paper_x32", "tiered_x4",
          "tiered_x16")


@pytest.mark.parametrize("name", FLEETS)
def test_fleets_match_jax(name):
    got = scenarios.get_fleet(name).build()
    ref = jscenarios.get_fleet(name).build()
    for field in ("eet", "p_dyn", "p_idle"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(ref, field)))
    for field in ("queue_size", "fairness_factor", "site_of_machine",
                  "tier_of_site", "n_sites", "sites", "tiers", "n_tiers"):
        assert getattr(got, field) == getattr(ref, field), field


BAD_PARTITIONS = [
    dict(site_of_machine=(0, 0, 1)),              # too short
    dict(site_of_machine=(0, 0, 2, 2)),           # site 1 empty
    dict(site_of_machine=(-1, 0, 0, 1)),          # negative
    dict(site_of_machine=(0, 0, 1, 1), tier_of_site=(0,)),
    dict(site_of_machine=(0, 0, 1, 1), tier_of_site=(0, -2)),
]


@pytest.mark.parametrize("kw", BAD_PARTITIONS)
def test_partition_validation_matches_jax(kw):
    base = dict(eet=SPEC.eet, p_dyn=SPEC.p_dyn, p_idle=SPEC.p_idle)
    with pytest.raises(ValueError) as ref:
        JaxSpec(**base, **kw)
    with pytest.raises(ValueError) as got:
        SystemSpec(**{k: np.asarray(v) for k, v in base.items()}, **kw)
    assert str(got.value) == str(ref.value)


def test_partition_properties():
    assert TSPEC.n_sites == 1 and TSPEC.sites == (0,) * 4
    spec = interop.system_from_arrays(
        SPEC.eet, SPEC.p_dyn, SPEC.p_idle,
        site_of_machine=np.array([0, 1, 0, 1]), tier_of_site=[0, 2])
    assert spec.site_of_machine == (0, 1, 0, 1)
    assert spec.n_sites == 2 and spec.tiers == (0, 2) and spec.n_tiers == 3
