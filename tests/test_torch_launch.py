"""The port's launchers and legacy shims against the JAX package's, on
the CPU.

``launch/serve.py`` prints the reference's text for the same arguments
(the request stream and the executed latencies come from the same numpy
seed); ``launch/elastic.py`` returns the reference's values on the
reference's own trace (the port's ``poisson_trace`` is patched, in this
test only, to hand it over: numpy cannot draw JAX's threefry stream);
the ``core/heuristics`` shim gives the reference shim's ``MapAction``s
on shared contexts; ``workload.trace_batch`` warns and equals
``trace_stack``; ``experiments.replace`` and ``types.EngineState``.
"""
import dataclasses
import functools
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import heuristics as jheur
from repro.core import types as jtypes
from repro.core import workload as jworkload
from repro.launch import elastic as jelastic
from repro.launch import serve as jserve
from repro.scenarios import get_fleet as jget_fleet
from repro_torch import interop
from repro_torch.core import api
from repro_torch.core import heuristics as theur
from repro_torch.core import types as ttypes
from repro_torch.core import workload
from repro_torch.datapipe import synthetic
from repro_torch.experiments import SweepSpec, replace
from repro_torch.launch import elastic, serve
from test_torch_common import (
    HEURISTICS,
    jax_context,
    port_context,
    random_context_arrays,
)

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def reference_serve(argv: tuple) -> str:
    import contextlib
    import io

    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["serve", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jserve.main()
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.mark.parametrize("rate", ["40", "1000"])
def test_serve_prints_the_reference_text(rate, capsys):
    argv = ("--requests", "40", "--rate", rate)
    want = reference_serve(argv)
    m = serve.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert m["arrived"].sum() == 40


def test_serve_takes_the_reference_flags(capsys):
    argv = ("--requests", "12", "--rate", "200", "--heuristic", "ELARE",
            "--archs", "qwen1.5-0.5b", "command-r-35b", "--tokens", "64",
            "--queue-size", "1", "--seed", "3")
    want = reference_serve(argv)
    serve.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == want


def test_serve_wants_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--requests", "2"])


# --------------------------------------------------------------------------
# elastic
# --------------------------------------------------------------------------
ELASTIC_ARGS = (("--tasks", "60", "--rate", "4.0", "--down", "1:0.25:0.5"),
                ("--tasks", "150", "--rate", "6.0", "--down",
                 "1:0.25:0.5,2:0.5:0.75", "--heuristic", "ELARE"))


def _flag(argv, name, default):
    return type(default)(argv[argv.index(name) + 1]) if name in argv \
        else default


@pytest.mark.parametrize("argv", ELASTIC_ARGS, ids=["one", "two"])
def test_elastic_matches_the_reference_on_its_trace(argv, monkeypatch,
                                                    capsys):
    want = jelastic.main(list(argv))
    want_text = capsys.readouterr().out
    spec = jget_fleet(_flag(argv, "--fleet", "paper_x4")).build()
    ref_trace = jworkload.poisson_trace(
        jax.random.PRNGKey(_flag(argv, "--seed", 0)),
        n_tasks=_flag(argv, "--tasks", 400),
        arrival_rate=_flag(argv, "--rate", 6.0), eet=spec.eet)

    def reference_trace(seed, n_tasks, arrival_rate, eet, device=None):
        np.testing.assert_array_equal(eet, spec.eet)
        return interop.trace_from_arrays(*map(np.asarray, ref_trace),
                                         device=device)

    monkeypatch.setattr(workload, "poisson_trace", reference_trace)
    got = elastic.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == want_text
    assert set(got) == set(want)
    assert got["ontime"] == want["ontime"]
    for k in ("orphans", "min_sites_live"):
        assert got[k] == want[k], k
    for k in ("healthy", "site_alive"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["min_sites_live"] < 4     # a site did leave


def test_elastic_runs_on_its_own_draw(capsys):
    res = elastic.main(["--tasks", "60", "--rate", "4.0", "--down",
                        "1:0.25:0.5", "--device", "cpu"])
    assert set(res) >= {"ontime", "orphans", "site_alive", "min_sites_live"}
    assert 0.0 <= res["ontime"] <= 1.0
    assert res["min_sites_live"] >= 1
    assert "capacity timeline" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the heuristics shim
# --------------------------------------------------------------------------
SELECTS = ("elare_select", "felare_select", "mm_select", "msd_select",
           "mmu_select", "met_select", "mct_select", "random_select")
B = 3


def _args(ctx):
    return (ctx.now, ctx.pending, ctx.task_type, ctx.deadline, ctx.view,
            ctx.sysarr, ctx.suffered)


def test_registry_view_matches_the_reference():
    assert list(theur.HEURISTICS) == list(jheur.HEURISTICS)
    assert len(theur.HEURISTICS) == len(jheur.HEURISTICS)
    assert set(HEURISTICS) <= set(theur.HEURISTICS)
    assert theur.get("felare") is theur.HEURISTICS["FELARE"]
    assert sorted(theur.__all__) == sorted(jheur.__all__)
    with pytest.raises(KeyError):
        theur.get("BOGUS")


@pytest.mark.parametrize("name", SELECTS)
def test_shim_selects_match_the_reference(name):
    a = random_context_arrays(B, 40, 4, 4, 2, seed=len(name))
    ctx = port_context(a)
    got = getattr(theur, name)(*_args(ctx))
    for b in range(B):
        want = getattr(jheur, name)(*_args(jax_context(a, b)))
        for field in ("assign", "drop", "queue_drop"):
            np.testing.assert_array_equal(
                getattr(got, field)[b].numpy(),
                np.asarray(getattr(want, field)), err_msg=f"{name} {field}")


@pytest.mark.parametrize("name", ["elare_select", "felare_select"])
def test_shim_phase1_impl_matches_the_reference(name):
    from repro_torch.kernels.phase1_map.ops import phase1_map

    a = random_context_arrays(B, 40, 4, 4, 2, seed=7)
    got = getattr(theur, name)(*_args(port_context(a)),
                               phase1_impl=phase1_map)
    for b in range(B):
        want = getattr(jheur, name)(*_args(jax_context(a, b)))
        for field in ("assign", "drop", "queue_drop"):
            np.testing.assert_array_equal(
                getattr(got, field)[b].numpy(),
                np.asarray(getattr(want, field)))


def test_elare_phase1_matches_the_reference():
    a = random_context_arrays(B, 40, 5, 4, 2, seed=3)
    ctx = port_context(a)
    qfree = torch.as_tensor(np.random.default_rng(4).integers(
        0, 2, (B, 5)).astype(bool))
    got = theur.elare_phase1(ctx.now, ctx.pending, ctx.task_type,
                             ctx.deadline, ctx.view, ctx.sysarr, qfree)
    for b in range(B):
        j = jax_context(a, b)
        want = jheur.elare_phase1(j.now, j.pending, j.task_type, j.deadline,
                                  j.view, j.sysarr,
                                  jax.numpy.asarray(qfree[b].numpy()))
        valid = np.asarray(want[2])
        np.testing.assert_array_equal(got[2][b].numpy(), valid)
        np.testing.assert_array_equal(got[0][b].numpy()[valid],
                                      np.asarray(want[0])[valid])
        for g, w in zip(got[1:2] + got[3:], want[1:2] + want[3:]):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_shim_reexports():
    from repro_torch.core import policy

    for name in ("BIG", "MachineView", "SchedContext", "avail_time",
                 "queued_eet"):
        assert getattr(theur, name) is getattr(policy, name)
    assert theur.BIG == jheur.BIG


# --------------------------------------------------------------------------
# the small shims
# --------------------------------------------------------------------------
def test_trace_batch_warns_and_equals_trace_stack():
    eet = api.paper_system().eet
    with pytest.warns(DeprecationWarning, match="trace_stack"):
        got = workload.trace_batch(5, 4, 50, 3.0, eet, cv_run=0.2,
                                   device="cpu")
    want = synthetic.trace_stack(5, (3.0,), 4, 50, eet, cv_run=0.2,
                                 device="cpu")
    assert isinstance(got, ttypes.Trace)
    for g, w in zip(got, want):
        assert g.shape == w.shape[1:]
        assert torch.equal(g, w[0])
    assert got.arrival.shape == (4, 50)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        workload.poisson_trace(5, 50, 3.0, eet, device="cpu")


def test_replace_is_dataclasses_replace():
    spec = SweepSpec()
    new = replace(spec, reps=3, heuristics=("ELARE",))
    assert new == dataclasses.replace(spec, reps=3, heuristics=("ELARE",))
    assert spec.reps != 3 and new.reps == 3
    with pytest.raises(TypeError):
        replace(spec, bogus=1)


def test_engine_state_has_the_reference_fields():
    assert ttypes.EngineState._fields == jtypes.EngineState._fields
    st = ttypes.EngineState(sim=None, aux={})
    assert st.aux == {} and st.sim is None
