"""The port's sweep end to end: parity with the JAX sweep on the
reference's own traces, port-side trace synthesis held in distribution,
the CLI's error handling, the device default, and the import boundary
(the port imports nothing of JAX or the JAX package)."""
import json
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro import experiments as jexp
from repro import scenarios as jscenarios
from repro.core import equations as jeq
from repro_torch import experiments as texp
from repro_torch import interop, scenarios
from repro_torch.core import api, engine
from repro_torch.core.types import Trace
from repro_torch.datapipe import synthetic
from repro_torch.experiments import sweep as tsweep
from test_torch_common import (
    CPU,
    COUNT_FIELDS,
    SPEC,
    TSPEC,
    assert_metrics_match,
    jax_trace,
)

torch.set_num_threads(1)

RATES, REPS, N_TASKS = (2.0, 5.0), 2, 60
SWEEP_H = ("ELARE", "FELARE", "MM")


def test_run_sweep_matches_jax_on_reference_traces():
    """Given the reference's own trace stack, the port's run_sweep gives
    the JAX run_sweep's per-cell counters and makespans."""
    jspec = jexp.SweepSpec(rates=RATES, reps=REPS, n_tasks=N_TASKS,
                           heuristics=SWEEP_H, seed=0)
    ref = jexp.run_sweep(jspec)
    stack = jscenarios.DEFAULT.stack(jax.random.PRNGKey(0), RATES, REPS,
                                     N_TASKS, SPEC.eet, cv_run=0.1)
    spec = texp.SweepSpec(rates=RATES, reps=REPS, n_tasks=N_TASKS,
                          heuristics=SWEEP_H, seed=0)
    got = texp.run_sweep(spec, traces=[np.asarray(x) for x in stack],
                         device=CPU)
    assert got.metrics.makespan.shape == (3, 2, 2)
    ref_m = {k: np.asarray(v) for k, v in ref.metrics._asdict().items()}
    got_m = got.metrics._asdict()
    assert_metrics_match(ref_m, got_m, "run_sweep",
                         n_machines=SPEC.n_machines)
    np.testing.assert_array_equal(got.completion_rate, ref.completion_rate)


def test_run_sweep_fused_flags_change_no_counter():
    spec = texp.SweepSpec(rates=RATES, reps=REPS, n_tasks=N_TASKS,
                          heuristics=SWEEP_H, seed=1)
    base = texp.run_sweep(spec, device=CPU)
    for flags in ({"use_fused_map": True}, {"use_fused_phase1": True}):
        other = texp.run_sweep(texp.SweepSpec(
            rates=RATES, reps=REPS, n_tasks=N_TASKS, heuristics=SWEEP_H,
            seed=1, **flags), device=CPU)
        for k in COUNT_FIELDS + ("makespan",):
            np.testing.assert_array_equal(getattr(other.metrics, k),
                                          getattr(base.metrics, k))


# ------------------------------------------------------------ federation
X2_RATES = (4.0, 10.0)


def test_federated_run_sweep_matches_jax_on_reference_traces():
    """paper_x2 with fair_spill: given the reference's own trace stack,
    the port's run_sweep gives the JAX run_sweep's counters and
    makespans, fused or not."""
    jspec = jexp.SweepSpec(system="paper_x2", rates=X2_RATES, reps=REPS,
                           n_tasks=N_TASKS, heuristics=("ELARE", "FELARE"),
                           seed=0, dispatcher="fair_spill")
    ref = jexp.run_sweep(jspec)
    stack = jscenarios.DEFAULT.stack(
        jax.random.PRNGKey(0), X2_RATES, REPS, N_TASKS,
        jscenarios.get_fleet("paper_x2").build().eet, cv_run=0.1)
    ref_m = {k: np.asarray(v) for k, v in ref.metrics._asdict().items()}
    for fused in (False, True):
        spec = texp.SweepSpec(system="paper_x2", rates=X2_RATES, reps=REPS,
                              n_tasks=N_TASKS, heuristics=("ELARE", "FELARE"),
                              seed=0, dispatcher="fair_spill",
                              use_fused_map=fused)
        got = texp.run_sweep(spec, traces=[np.asarray(x) for x in stack],
                             device=CPU)
        assert_metrics_match(ref_m, got.metrics._asdict(),
                             f"paper_x2 fair_spill fused={fused}",
                             n_machines=8)


def test_cli_federated_probe_fused_changes_no_counter(capsys):
    argv = ["--device", "cpu", "--system", "paper_x2", "--dispatcher",
            "fair_spill", "--rates", "4", "--reps", "2", "--tasks", "60"]
    base = tsweep.main(argv)
    assert "sites=2 dispatcher=fair_spill" in capsys.readouterr().out
    fused = tsweep.main(argv + ["--fused-map"])
    for k in COUNT_FIELDS + ("makespan",):
        np.testing.assert_array_equal(getattr(fused.metrics, k),
                                      getattr(base.metrics, k), err_msg=k)


def test_cli_list_dispatchers(capsys):
    with pytest.raises(SystemExit) as exc:
        tsweep.build_spec(["--list-dispatchers"])
    assert exc.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "fair_spill", "health_aware", "least_queued", "min_eet",
        "round_robin", "sticky", "tier_aware"]


def test_spec_dispatcher_validation_matches_jax():
    for bad in ("BOGUS", 42):
        with pytest.raises(ValueError) as ref:
            jexp.SweepSpec(dispatcher=bad)
        with pytest.raises(ValueError) as got:
            texp.SweepSpec(dispatcher=bad)
        assert str(got.value) == str(ref.value)
    spec = texp.SweepSpec(system="paper_x2", dispatcher=" Fair_Spill ")
    assert spec.dispatcher == "fair_spill"
    assert spec.to_json_dict()["dispatcher"] == "fair_spill"
    from repro_torch.core import dispatch

    custom = texp.SweepSpec(dispatcher=dispatch.Sticky(salt=3))
    assert custom.to_json_dict()["dispatcher"] == {"kind": "sticky",
                                                   "salt": 3,
                                                   "by_type": False}


def test_run_study_on_a_federation():
    res = api.run_study("FELARE", (6.0,), scenarios.get_fleet(
        "paper_x2").build(), n_traces=2, n_tasks=40,
        dispatcher="least_queued", device=CPU)
    assert res[0].arrival_rate == 6.0 and 0 <= res[0].completion_rate <= 1


# ----------------------------------------------------- synthesis, in law
def test_poisson_rate_and_sorted_arrivals():
    n, rate = 20000, 4.0
    tr = scenarios.DEFAULT.sample_trace(3, n, rate, SPEC.eet, device=CPU)
    arr = tr.arrival.numpy()
    assert arr.dtype == np.float32 and np.all(np.diff(arr) >= 0)
    assert arr[0] > 0
    # N / T_N estimates the rate with relative sd 1 / sqrt(N).
    est = n / float(arr[-1])
    assert abs(est / rate - 1) < 5 / np.sqrt(n)
    # ... and agrees with the reference's own sampler in law.
    ref = np.asarray(jax_trace(3, n, rate).arrival)
    assert abs(float(arr[-1]) / float(ref[-1]) - 1) < 7 / np.sqrt(n)


def test_deadlines_follow_eq4_exactly():
    tr = scenarios.DEFAULT.sample_trace(5, 500, 3.0, SPEC.eet, device=CPU)
    ref = np.asarray(jeq.deadlines(tr.arrival.numpy(),
                                   tr.task_type.numpy().astype(np.int32),
                                   SPEC.eet))
    np.testing.assert_array_equal(tr.deadline.numpy(), ref)


def test_uniform_mix_and_gamma_runtimes():
    n, cv = 20000, 0.1
    tr = scenarios.DEFAULT.sample_trace(7, n, 3.0, SPEC.eet, cv_run=cv,
                                        device=CPU)
    tt = tr.task_type.numpy()
    counts = np.bincount(tt, minlength=4)
    p = 0.25
    assert np.all(np.abs(counts / n - p) < 5 * np.sqrt(p * (1 - p) / n))
    ratio = tr.exec_actual.numpy() / SPEC.eet[tt]        # Gamma(mean 1, cv)
    k = ratio.size
    assert abs(ratio.mean() - 1) < 5 * cv / np.sqrt(k)
    assert abs(ratio.std() / ratio.mean() - cv) < 0.05 * cv
    assert np.all(ratio > 0)


def test_common_random_numbers_across_rates():
    rates = (2.0, 5.0, 8.0)
    st = synthetic.trace_stack(11, rates, 3, 200, SPEC.eet, device=CPU)
    assert st.arrival.shape == (3, 3, 200)
    assert st.exec_actual.shape == (3, 3, 200, 4)
    for r in range(1, 3):
        assert torch.equal(st.task_type[r], st.task_type[0])
        assert torch.equal(st.exec_actual[r], st.exec_actual[0])
        np.testing.assert_allclose(st.arrival[r].numpy() * rates[r],
                                   st.arrival[0].numpy() * rates[0],
                                   rtol=1e-5)
    # replicates differ from each other
    assert not torch.equal(st.task_type[0, 0], st.task_type[0, 1])
    # the same seed gives the same stack
    again = synthetic.trace_stack(11, rates, 3, 200, SPEC.eet, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(st, again))


# ---------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv,needle", [
    (["--rates", "1:5:0"], "rate step must be positive"),
    (["--heuristics", "BOGUS"], "unknown heuristics"),
    (["--reps", "0"], "reps must be >= 1"),
    (["--system", "nowhere"], "unknown system"),
    (["--system", "paper_x2", "--dispatcher", "BOGUS"],
     "unknown dispatcher 'BOGUS'"),
])
def test_cli_errors_exit_2(argv, needle, capsys):
    with pytest.raises(SystemExit) as exc:
        tsweep.build_spec(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "error:" in err and needle in err


def test_cli_runs_on_cpu(tmp_path, capsys):
    res = tsweep.main(["--device", "cpu", "--rates", "2,5", "--reps", "2",
                       "--tasks", "40", "--heuristics", "MM,FELARE",
                       "--fused-map", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "FELARE" in out and "device=cpu" in out
    assert (tmp_path / "sweep.csv").exists()
    data = json.loads((tmp_path / "sweep.json").read_text())
    assert data["device"] == "cpu" and len(data["summary"]) == 4
    assert res.metrics.makespan.shape == (2, 2, 2)


def test_cli_list(capsys):
    with pytest.raises(SystemExit) as exc:
        tsweep.build_spec(["--list"])
    assert exc.value.code == 0
    assert "min_energy_feasible" in capsys.readouterr().out


# ------------------------------------------------------- device default
def test_entry_points_raise_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = scenarios.DEFAULT.sample_trace(0, 20, 2.0, SPEC.eet, device=CPU)
    spec = texp.SweepSpec(rates=(2.0,), reps=1, n_tasks=20,
                          heuristics=("MM",))
    calls = [
        lambda: engine.simulate(tr, TSPEC, "MM"),
        lambda: engine.simulate_batch(Trace(*(x[None] for x in tr)), TSPEC,
                                      "MM"),
        lambda: texp.run_sweep(spec),
        lambda: api.run_study("MM", (2.0,), api.paper_system(), n_traces=1,
                              n_tasks=20),
        lambda: synthetic.trace_stack(0, (2.0,), 1, 20, SPEC.eet),
        lambda: interop.trace_from_arrays(*(x.numpy() for x in tr)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    with pytest.raises(SystemExit) as exc:
        tsweep.build_spec(["--rates", "2"])
    assert exc.value.code == 2
    assert 'device="cpu"' in capsys.readouterr().err


def test_run_study_on_cpu():
    res = api.run_study("FELARE", (2.0, 6.0), api.paper_system(),
                        n_traces=2, n_tasks=40, device=CPU)
    assert [r.arrival_rate for r in res] == [2.0, 6.0]
    assert all(0 <= r.completion_rate <= 1 for r in res)
    assert res[0].completion_rate_by_type.shape == (4,)


# ------------------------------------------------------ import boundary
def test_port_imports_no_jax_and_no_reference():
    """Every repro_torch module imports with ``jax`` and ``repro`` blocked."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))
    assert "repro_torch.core.engine" in names
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": repro_torch.__path__[0] + "/..",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
