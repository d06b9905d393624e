"""The plain reference against the port run on the CPU, on the
benchmark's dyadic traces: per-type counters and makespan identical,
energies within 1e-5 of the replicate's total (the port accumulates
float32, the reference float64)."""
import numpy as np
import pytest

from portbench_common import CONFIGS, row, system, tiny_stack
from portbench import compare
from portbench.reference import sim

from repro_torch.experiments import runner
from repro_torch.experiments.spec import SweepSpec

CASES = [
    ("paper-hec-4x4", "ELARE", "sticky", False, True, (2.0, 8.0)),
    ("paper-hec-4x4", "FELARE", "sticky", True, False, (2.0, 8.0)),
    ("paper-hec-4x4", "FELARE", "sticky", False, False, (3.0, 6.0)),
    ("paper-x8", "FELARE", "fair_spill", True, False, (16.0, 64.0)),
    ("paper-x8", "FELARE", "sticky", True, False, (24.0, 48.0)),
    ("paper-x8", "ELARE", "fair_spill", False, False, (16.0, 64.0)),
    ("paper-x8", "ELARE", "sticky", True, False, (32.0, 64.0)),
]


@pytest.mark.parametrize("config,policy,dispatcher,fused,phase1,rates", CASES)
def test_reference_equals_port(config, policy, dispatcher, fused, phase1,
                               rates):
    cfg = CONFIGS[config]
    reps, n = 2, 120
    traces = tiny_stack(cfg, rates, reps, n)
    spec = SweepSpec(system=cfg["fleet"], rates=rates, reps=reps, n_tasks=n,
                     heuristics=(policy,), dispatcher=dispatcher,
                     use_fused_map=fused, use_fused_phase1=phase1)
    m = runner.run_sweep(spec, traces=traces, device="cpu").metrics
    sysm = system(cfg)
    for r in range(len(rates)):
        for k in range(reps):
            ref = sim.simulate(row(traces, r, k), sysm, policy, dispatcher)
            port = {f: np.asarray(v)[0, r, k] for f, v in m._asdict().items()}
            differ, gap = compare.gaps(port, ref)
            assert not differ, (config, policy, dispatcher, r, k)
            assert gap < 1e-5, gap
            assert ref["steps"] < 8 * n + 64


def test_traces_are_dyadic_and_sorted():
    cfg = CONFIGS["paper-x8"]
    tr = tiny_stack(cfg, (16.0, 64.0), 3, 50)
    for x in (tr[0], tr[2], tr[3]):
        v = x.double().numpy()
        assert np.array_equal(v * 64, np.round(v * 64))
    assert (np.diff(tr[0].numpy(), axis=-1) >= 0).all()
    assert (tr[3].numpy() > 0).all()
    # common random numbers: the rates share types and runtimes
    assert np.array_equal(tr[1][0].numpy(), tr[1][1].numpy())
    assert np.array_equal(tr[3][0].numpy(), tr[3][1].numpy())


def test_traces_follow_the_seed():
    cfg = CONFIGS["paper-hec-4x4"]
    a = tiny_stack(cfg, (2.0,), 2, 30, seed=2**31 + 11, batch=3)
    b = tiny_stack(cfg, (2.0,), 2, 30, seed=2**31 + 11, batch=3)
    c = tiny_stack(cfg, (2.0,), 2, 30, seed=2**31 + 11, batch=4)
    assert all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(a, b))
    assert not np.array_equal(a[0].numpy(), c[0].numpy())
