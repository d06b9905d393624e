"""Federation parity on the block fold: the port's engine at F > 1 against
the JAX engine and the pure-Python oracle (``repro.core.pyengine``).

``paper_x2``'s two sites are equal contiguous blocks, which the port
folds by reshaping each replicate's machines into F rows of m, as the
reference's block path does. On dyadic traces the per-type counters, the
makespan and every task's final site must be identical, and so must the
idle energy against the JAX engine (8 machines: the port sums in the
order of the reference's compiled code); the other energies, and all of
them against the float64 oracle, agree within rel 1e-5. Each run
is checked with and without ``use_fused_map`` (on the CPU the kernels'
plain versions, the balance walk included).

RANDOM is held to the JAX engine only, final sites from its ``task_log``
included: its nominator hashes into the width of the view, a site's m
machines on the block fold, while the oracle hashes into all M machines;
the JAX package's own federation tests never run it against the oracle.

Also here: the frozen ``site`` of finished replicates and the flat
system's indifference to the dispatcher. The masked fold and the widest
block fold (``paper_x8``) are in ``test_torch_federation_masked.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro_torch import interop, scenarios
from repro_torch.core import dispatch
from repro_torch.core import engine as tengine
from repro_torch.core.types import Trace
from test_torch_common import (
    CPU,
    assert_metrics_match,
    jax_federated,
    jax_trace,
    port_federated,
    port_spec,
    stack_traces,
)

torch.set_num_threads(1)

SEEDS = (0, 7)
# About three tasks/s per paper site, so queues fill and the dispatchers'
# choices matter.
N_TASKS, RATE = 64, 6.0
SPEC2 = jscenarios.get_fleet("paper_x2").build()
# Every built-in that differs from another at F > 1 without faults or a
# network (health_aware is sticky there, tier_aware min_eet).
DISPATCHERS = ("sticky", "round_robin", "least_queued", "min_eet",
               "fair_spill")


@functools.lru_cache(maxsize=None)
def _traces():
    return tuple(jax_trace(s, N_TASKS, RATE, SPEC2.eet) for s in SEEDS)


@functools.lru_cache(maxsize=None)
def _reference(heuristic, dispatcher):
    return jax_federated(SPEC2, _traces(), heuristic, dispatcher,
                         task_log=heuristic == "RANDOM")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("dispatcher", DISPATCHERS)
@pytest.mark.parametrize("heuristic", ["ELARE", "FELARE", "RANDOM"])
def test_block_fold_matches_jax_and_oracle(heuristic, dispatcher, fused):
    port, sites = port_federated(port_spec(SPEC2), stack_traces(_traces()),
                                 heuristic, dispatcher, fused)
    jax_rows, jax_sites, oracle = _reference(heuristic, dispatcher)
    assert (sites >= 0).all() and (sites < SPEC2.n_sites).all()
    if jax_sites is not None:
        np.testing.assert_array_equal(sites, jax_sites, err_msg="sites")
    for i, seed in enumerate(SEEDS):
        row = {k: v[i] for k, v in port.items()}
        what = f"{heuristic} {dispatcher} seed {seed}"
        assert_metrics_match(jax_rows[i], row, what + " jax",
                             n_machines=SPEC2.n_machines)
        if heuristic != "RANDOM":
            assert_metrics_match(oracle[i], row, what + " oracle")
            np.testing.assert_array_equal(
                sites[i], oracle[i]["task_log"]["site"],
                err_msg=what + " oracle sites")


@pytest.mark.parametrize("dispatcher", ["fair_spill", "least_queued"])
def test_batched_equals_per_trace_loop(dispatcher):
    """Replicates that finish far apart (rates 2 and 16 tasks/s) in one
    batch: the finished one is frozen, its sites included, so the batch
    equals each trace run alone, field for field."""
    tspec = port_spec(SPEC2)
    trs = stack_traces([jax_trace(3, 60, 2.0, SPEC2.eet),
                        jax_trace(4, 60, 16.0, SPEC2.eet)])
    batched, sites = port_federated(tspec, trs, "FELARE", dispatcher, False)
    for i in range(2):
        alone = Trace(*(x[i:i + 1] for x in trs))
        m, s = port_federated(tspec, alone, "FELARE", dispatcher, False)
        np.testing.assert_array_equal(sites[i], s[0])
        for k, v in m.items():
            np.testing.assert_array_equal(batched[k][i], v[0], err_msg=k)


@pytest.mark.parametrize("fleet", ["paper", "aws"])
def test_flat_system_ignores_the_dispatcher(fleet):
    """One site: no dispatch stage, so every dispatcher gives the same
    metrics, bit for bit."""
    tspec = scenarios.get_fleet(fleet).build()
    trs = stack_traces([jax_trace(s, 30, 3.0, tspec.eet) for s in SEEDS])
    runs = [interop.metrics_to_numpy(tengine.simulate_batch(
        trs, tspec, "FELARE", dispatcher=d, use_fused_map=True, device=CPU))
        for d in dispatch.list_dispatchers()]
    for other in runs[1:]:
        for k, v in runs[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
