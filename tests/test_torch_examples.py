"""``examples/torch_quickstart.py`` and ``examples/torch_fault_tolerance.py``
against ``examples/quickstart.py`` and ``examples/fault_tolerance.py`` on
the CPU.

Each port example takes its traces as an argument; given the reference's
own draws (carried over as numpy arrays) it must print the reference
example's text, every number the same. On its own numpy draws it must
show the claims the repo's verify notes make: ELARE and FELARE waste less
energy than MM at rates 4-8, FELARE's per-type completion is flatter
than ELARE's, and under the outage on-time goes sticky < fair_spill <
health_aware.
"""
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro import scenarios as jscen
from repro.core import workload as jworkload
from repro_torch import interop

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUICK_ARGS = ["--tasks", "200", "--traces", "3"]


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_lines(monkeypatch, capsys, name: str, argv) -> list:
    mod = load(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return capsys.readouterr().out.splitlines()


def port_lines(capsys, name: str, argv, **kw) -> list:
    assert load(name).main([*argv, "--device", "cpu"], **kw) == 0
    return capsys.readouterr().out.splitlines()


def reference_sweep_traces(port_args):
    """The trace stack the reference quickstart's ``run_sweep`` draws
    (``PRNGKey(spec.seed)``), as numpy arrays in a port Trace."""
    spec = jexp.SweepSpec(system=None, scenario=port_args.scenario,
                          rates=tuple(port_args.rates), reps=port_args.traces,
                          n_tasks=port_args.tasks)
    stacked = spec.resolve_scenario().stack(
        jax.random.PRNGKey(spec.seed), spec.rates, spec.reps, spec.n_tasks,
        spec.resolve_system().eet, cv_run=spec.cv_run)
    return interop.trace_from_arrays(
        *(np.asarray(getattr(stacked, f))
          for f in ("arrival", "task_type", "deadline", "exec_actual")),
        device="cpu")


def table(lines) -> dict:
    """{(heuristic, rate): (ontime, waste, per-type completion)}."""
    out = {}
    for ln in lines:
        parts = ln.split()
        if len(parts) >= 7 and parts[0] in ("MM", "MSD", "MMU", "ELARE",
                                            "FELARE"):
            per = [float(x.strip("[]")) for x in ln.split("[")[1].split()]
            out[parts[0], float(parts[1])] = (float(parts[2]),
                                              float(parts[3]), per)
    return out


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    want = reference_lines(monkeypatch, capsys, "quickstart", QUICK_ARGS)
    port = load("torch_quickstart")
    traces = reference_sweep_traces(port.parse(QUICK_ARGS))
    got = port_lines(capsys, "torch_quickstart", QUICK_ARGS, traces=traces)
    assert got == want
    assert len(table(got)) == 15


def test_quickstart_claims_on_its_own_draws(capsys):
    """The paper's claims (verify notes, surface 3) on the port's draw:
    ELARE and FELARE waste less than MM at rates 4 and 8, and FELARE's
    per-type completion spread (max - min) is below ELARE's there."""
    rows = table(port_lines(capsys, "torch_quickstart", QUICK_ARGS))
    for rate in (4.0, 8.0):
        for h in ("ELARE", "FELARE"):
            assert rows[h, rate][1] < rows["MM", rate][1], (h, rate)
        spread = {h: max(rows[h, rate][2]) - min(rows[h, rate][2])
                  for h in ("ELARE", "FELARE")}
        assert spread["FELARE"] < spread["ELARE"], (rate, spread)


def test_quickstart_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert load("torch_quickstart").main(QUICK_ARGS) == 2
    assert capsys.readouterr().out.startswith("error:")


def reference_outage_trace():
    """The reference demo's trace (``PRNGKey(0)``), as a port Trace."""
    eet = jscen.get_fleet("paper_x4").build().eet
    tr = jworkload.poisson_trace(jax.random.PRNGKey(0), n_tasks=400,
                                 arrival_rate=6.0, eet=eet)
    return interop.trace_from_arrays(
        *(np.asarray(getattr(tr, f))
          for f in ("arrival", "task_type", "deadline", "exec_actual")),
        device="cpu")


def ontime_column(lines) -> list:
    return [float(ln.split("on-time")[1].split("%")[0]) for ln in lines
            if "on-time" in ln]


def test_fault_tolerance_matches_the_reference(monkeypatch, capsys):
    want = reference_lines(monkeypatch, capsys, "fault_tolerance", [])
    got = port_lines(capsys, "torch_fault_tolerance", [],
                     trace=reference_outage_trace())
    assert got == want


def test_fault_tolerance_claims_on_its_own_draw(capsys):
    """sticky < fair_spill < health_aware on-time under the outage, on
    the port's own numpy draw."""
    base, sticky, spill, health, _ = ontime_column(
        port_lines(capsys, "torch_fault_tolerance", []))
    assert sticky < spill < health


@pytest.mark.parametrize("B", [1, 3])
def test_site_tables_under_faults_are_contiguous(B):
    """The fault demo runs one trace (B = 1) of a block-folded federation
    under an outage: the health-masked site tables the kernels take must
    be contiguous (at B = 1 the fold is a view), with the same values."""
    from repro_torch.core import engine

    spec = load("torch_fault_tolerance").fleet()
    sysarr = spec.as_torch("cpu")
    fold = engine._make_fold(sysarr, spec.site_of_machine)
    assert fold.block
    eet = torch.arange(B * np.prod(sysarr.eet.shape), dtype=torch.float32
                       ).reshape(B, *sysarr.eet.shape)
    got = engine._site_eet(fold, eet)
    F, (S, M) = fold.n_sites, sysarr.eet.shape
    assert got.is_contiguous()
    want = eet.reshape(B, S, F, M // F).permute(0, 2, 1, 3)
    assert torch.equal(got, want.reshape(B * F, S, M // F))
