"""Engine parity: the port's batched event loop against the JAX engine and
the pure-Python oracle (``repro.core.pyengine``).

On dyadic traces (``tests/test_engine.py``'s rounding) the per-type
counters and the makespan must be identical for all 8 heuristics, with
and without ``use_fused_map``, and so must the idle energy against the
JAX engine (the port sums it left to right with an FMA per machine, as
the reference's compiled code does up to 8 machines); the other
energies, and all of them against the float64 oracle, agree within rel
1e-5. The JAX side runs its lax path: lax == fused is pinned by
``tests/test_map_fused.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import pyengine
from repro_torch import interop
from repro_torch.core import engine as tengine
from repro_torch.core.types import Trace
from test_torch_common import (
    CPU,
    HEURISTICS,
    SPEC,
    TSPEC,
    assert_metrics_match,
    jax_trace,
    stack_traces,
)

torch.set_num_threads(1)

SEEDS = (0, 7)
N_TASKS, RATE = 120, 2.5


@functools.lru_cache(maxsize=None)
def _traces():
    return tuple(jax_trace(s, N_TASKS, RATE) for s in SEEDS)


@functools.lru_cache(maxsize=None)
def _reference(heuristic):
    """(JAX engine, pyengine) metrics per seed, as dicts of numpy."""
    trs = _traces()
    batch = jax.tree.map(lambda *xs: np.stack(xs), *trs)
    mj = jengine.simulate_batch(batch, SPEC, heuristic)
    jax_rows = [{k: np.asarray(v)[i] for k, v in mj._asdict().items()}
                for i in range(len(trs))]
    oracle = [pyengine.simulate(tr, SPEC, heuristic) for tr in trs]
    return jax_rows, oracle


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_engine_matches_jax_and_oracle(heuristic, fused):
    port = interop.metrics_to_numpy(tengine.simulate_batch(
        stack_traces(_traces()), TSPEC, heuristic, use_fused_map=fused,
        device=CPU))
    jax_rows, oracle = _reference(heuristic)
    for i, seed in enumerate(SEEDS):
        row = {k: v[i] for k, v in port.items()}
        assert_metrics_match(jax_rows[i], row, f"{heuristic} seed {seed} jax",
                             n_machines=TSPEC.n_machines)
        assert_metrics_match(oracle[i], row, f"{heuristic} seed {seed} oracle")


@pytest.mark.parametrize("heuristic", ["ELARE", "FELARE"])
def test_fused_phase1_engine_matches_jax(heuristic):
    port = interop.metrics_to_numpy(tengine.simulate_batch(
        stack_traces(_traces()), TSPEC, heuristic, use_fused_phase1=True,
        device=CPU))
    jax_rows, _ = _reference(heuristic)
    for i in range(len(SEEDS)):
        assert_metrics_match(jax_rows[i], {k: v[i] for k, v in port.items()},
                             f"{heuristic} phase1 seed {SEEDS[i]}",
                             n_machines=TSPEC.n_machines)


def _single(trace, i):
    return Trace(*(x[i] for x in trace))


@pytest.mark.parametrize("max_steps", [None, 150])
@pytest.mark.parametrize("heuristic", ["FELARE", "MMU"])
def test_batched_equals_per_trace_loop(heuristic, max_steps):
    """Replicates of very different lengths (rates 0.5 and 8 tasks/s) in
    one batch: the short one is frozen while the long one runs on, so the
    batch equals each trace simulated alone, field for field. With a step
    cap, every replicate stops at the cap exactly as it would alone."""
    trs = stack_traces([jax_trace(3, 60, 0.5), jax_trace(4, 60, 8.0),
                        jax_trace(5, 60, 2.0)])
    batched = interop.metrics_to_numpy(tengine.simulate_batch(
        trs, TSPEC, heuristic, max_steps=max_steps, device=CPU))
    for i in range(3):
        alone = interop.metrics_to_numpy(tengine.simulate(
            _single(trs, i), TSPEC, heuristic, max_steps=max_steps,
            device=CPU))
        for k, v in alone.items():
            np.testing.assert_array_equal(batched[k][i], v, err_msg=k)


def test_task_conservation():
    """Every arrived task ends exactly one of completed/missed/cancelled."""
    for heuristic in ("MM", "ELARE", "FELARE"):
        m = tengine.simulate(_single(stack_traces(_traces()), 0), TSPEC,
                             heuristic, device=CPU)
        total = m.completed_by_type + m.missed_by_type + m.cancelled_by_type
        assert torch.equal(total, m.arrived_by_type)
        assert int(m.arrived_by_type.sum()) == N_TASKS
        assert float(m.energy_wasted) <= float(m.energy_dynamic) + 1e-4


def test_unfaulted_idle_energy_bit_for_bit_with_jax():
    """The case that showed the unfaulted idle energy one ulp off the
    reference's (paper, FELARE, ``jax_trace(3, 100, 4.0)``: 0.53593755
    against 0.5359375 while the port summed rounded products with
    ``torch.sum``): the Metrics' idle energy, summed left to right with
    an FMA per machine as XLA's CPU code sums it, is the reference's bit
    for bit, batched and single, plain and fused."""
    tr = jax_trace(3, 100, 4.0)
    want = np.asarray(jengine.simulate(tr, SPEC, "FELARE").energy_idle)
    batch = stack_traces([tr, jax_trace(5, 100, 4.0)])
    for fused in (False, True):
        got = tengine.simulate_batch(batch, TSPEC, "FELARE", device=CPU,
                                     use_fused_map=fused).energy_idle
        assert got[0].numpy().tobytes() == want.tobytes(), fused
        one = tengine.simulate(_single(batch, 0), TSPEC, "FELARE",
                               device=CPU, use_fused_map=fused)
        assert one.energy_idle.numpy().tobytes() == want.tobytes(), fused
