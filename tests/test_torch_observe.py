"""The port's engine observers (``repro_torch.core.observe``) against the
JAX package's (``repro.core.observe``) on identical dyadic traces.

Mirrors ``tests/test_observe.py`` case for case where a case applies, and
holds every observer field for field against the live JAX engine:
``task_log`` (also against ``pyengine``'s log), ``timeline`` at K = 64
and 48, flat and per site, ``fairness_trajectory`` with the inherited and
an explicit factor, and ``energy_budget`` with its halt. Every comparison
is bit for bit (``np.testing.assert_array_equal``, dtypes included) but
one: ``timeline.e_idle`` on systems of more than 8 machines, where XLA's
CPU code vectorizes the sum over machines and the port sums left to
right (ROADMAP C names it).

``test_observers_add_no_retraces`` has no counterpart here: the port
runs one Python loop and compiles nothing per observer. Its place is
taken by :func:`test_observers_read_nothing_back`, which holds the
observers and the engine's loop free of host syncs.
"""
import dataclasses
import functools
import inspect
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro import scenarios as jscenarios
from repro.core import api as japi
from repro.core import observe as jobs
from repro.core import pyengine
from repro_torch import experiments as texp
from repro_torch import interop
from repro_torch.core import engine as tengine
from repro_torch.core import observe as tobs
from repro_torch.experiments import sweep as tsweep
from test_torch_common import (
    CPU,
    HEURISTICS,
    SPEC,
    TSPEC,
    assert_metrics_match,
    jax_trace,
    jengine,
    port_spec,
    stack_traces,
)

torch.set_num_threads(1)

SEEDS_RATES = ((0, 3.0), (5, 6.0), (9, 9.0))
N_TASKS = 100


@functools.lru_cache(maxsize=None)
def _traces(n=N_TASKS, eet_key=None):
    eet = None if eet_key is None else _fleet(eet_key).eet
    return tuple(jax_trace(s, n, r * (1 if eet is None else 2), eet)
                 for s, r in SEEDS_RATES)


@functools.lru_cache(maxsize=None)
def _fleet(name):
    return jscenarios.get_fleet(name).build()


def _batch(traces):
    return jax.tree.map(lambda *xs: np.stack(xs), *traces)


def assert_aux_equal(jaux: dict, taux: dict, what: str, close=()) -> None:
    """Every leaf of every observer equal, dtype and shape included;
    ``close`` names (observer, leaf) pairs held within rel 1e-6."""
    assert set(taux) == set(jaux), what
    for ob, leaves in jaux.items():
        assert set(taux[ob]) == set(leaves), (what, ob)
        for k, v in leaves.items():
            want = np.asarray(v)
            got = taux[ob][k].numpy()
            msg = f"{what}: {ob}.{k}"
            assert got.dtype == want.dtype and got.shape == want.shape, msg
            if (ob, k) in close:
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=msg)
            else:
                np.testing.assert_array_equal(got, want, err_msg=msg)


def assert_metrics_equal(jm, tm, what: str,
                         n_machines: int = SPEC.n_machines) -> None:
    """The engine's own parity: counters, makespans and, up to 8
    machines, the idle energy identical; the other energies within rel
    1e-5 (the engine's own sums; the observers' are held bit for bit)."""
    assert_metrics_match({k: np.asarray(v) for k, v in jm._asdict().items()},
                         interop.metrics_to_numpy(tm), what,
                         n_machines=n_machines)


@functools.lru_cache(maxsize=None)
def _jax_observed(heuristic, observers, fleet=None, dispatcher=None):
    spec = SPEC if fleet is None else _fleet(fleet)
    return jengine.simulate_batch(
        _batch(_traces(eet_key=fleet)), spec, heuristic,
        observers=observers, dispatcher=dispatcher)


def _one(tr):
    """One reference trace as a port Trace without the batch dim."""
    batched = stack_traces([tr])
    return type(batched)(*(x[0] for x in batched))


def _port_observed(heuristic, observers, fleet=None, dispatcher=None,
                   fused=False, spec=None):
    if spec is None:
        spec = TSPEC if fleet is None else port_spec(_fleet(fleet))
    return tengine.simulate_batch(
        stack_traces(_traces(eet_key=fleet)), spec, heuristic,
        observers=observers, dispatcher=dispatcher, use_fused_map=fused,
        device=CPU)


# ----------------------------------------------------------------- registry
def test_builtins_registered():
    names = tobs.list_observers()
    assert names == ["energy_budget", "fairness_trajectory", "health",
                     "network", "task_log", "timeline"]
    for name in names:
        assert tobs.is_registered(name)
        assert tobs.describe(name) == jobs.describe(name)
    assert isinstance(tobs.get("TIMELINE"), tobs.Timeline)  # case-insens


def test_register_round_trip_and_unknown_name():
    ob = tobs.Timeline(n_buckets=7)
    tobs.register("My-Timeline", ob)
    try:
        got = tobs.get("my-timeline")
        # the registered name is rebound onto the instance
        assert got == tobs.Timeline(n_buckets=7, name="my-timeline")
        assert tobs.resolve(("my-timeline",)) == (got,)
    finally:
        tobs.unregister("my-timeline")
    with pytest.raises(KeyError, match="choose from"):
        tobs.get("nope")
    with pytest.raises(TypeError, match="Observer protocol"):
        tobs.register("bad", object())


def test_registered_name_keys_the_aux():
    """Two same-class observers under distinct registry names coexist in
    one run, each keyed by its registered name; one name twice is
    refused."""
    tobs.register("tl-coarse", tobs.Timeline(n_buckets=4))
    tobs.register("tl-fine", tobs.Timeline(n_buckets=16))
    try:
        tr = stack_traces(_traces(40))
        _, aux = tengine.simulate_batch(tr, TSPEC, "MM", device=CPU,
                                        observers=("tl-coarse", "tl-fine"))
        assert aux["tl-coarse"]["e_dyn"].shape == (3, 4)
        assert aux["tl-fine"]["e_dyn"].shape == (3, 16)
        with pytest.raises(ValueError, match="duplicate observer names"):
            tengine.simulate_batch(tr, TSPEC, "MM", device=CPU,
                                   observers=("timeline", tobs.Timeline()))
    finally:
        tobs.unregister("tl-coarse")
        tobs.unregister("tl-fine")


def test_json_kinds_round_trip_and_unported_kinds_raise():
    for ob in (tobs.Timeline(n_buckets=8, per_site=True), tobs.TaskLog(),
               tobs.FairnessTrajectory(fairness_factor=0.5),
               tobs.EnergyBudget(capacity=12.5), tobs.EnergyBudget(),
               tobs.Health(n_buckets=8), tobs.Network(n_buckets=8)):
        d = json.loads(json.dumps(ob.to_json_dict()))
        assert tobs.from_json_dict(d) == ob
    # every reference kind is ported now: none raises any more
    assert set(tobs._KINDS) == set(jobs._KINDS)
    assert all(cls is not None for cls in tobs._KINDS.values())
    with pytest.raises(ValueError, match="unknown observer kind"):
        tobs.from_json_dict({"kind": "bogus"})


def test_spec_rejects_unknown_observer():
    with pytest.raises(ValueError, match="unknown observer"):
        texp.SweepSpec(observers=("nope",))
    with pytest.raises(ValueError, match="Observer protocol"):
        texp.SweepSpec(observers=(42,))


def test_spec_json_records_observers_as_jax_does():
    kw = dict(rates=(2.0,), reps=2, n_tasks=40, heuristics=("MM",))
    ours = texp.SweepSpec(**kw, observers=(
        "TimeLine", tobs.EnergyBudget(capacity=123.0),
        tobs.FairnessTrajectory(n_buckets=16)))
    ref = jexp.SweepSpec(**kw, observers=(
        "TimeLine", jobs.EnergyBudget(capacity=123.0),
        jobs.FairnessTrajectory(n_buckets=16)))
    assert ours.observers[0] == "timeline"
    assert (ours.to_json_dict()["observers"]
            == ref.to_json_dict()["observers"])
    json.dumps(ours.to_json_dict())


# ---------------------------------------------------------------- task_log
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_task_log_matches_jax_and_oracle(heuristic, fused):
    """task_log field for field against the JAX engine's, and event for
    event against ``pyengine``'s log."""
    jm, jaux = _jax_observed(heuristic, ("task_log",))
    tm, taux = _port_observed(heuristic, ("task_log",), fused=fused)
    assert_metrics_equal(jm, tm, heuristic)
    assert_aux_equal(jaux, taux, heuristic)
    for i, tr in enumerate(_traces()):
        ref = pyengine.simulate(tr, SPEC, heuristic)["task_log"]
        log = {k: v[i].numpy() for k, v in taux["task_log"].items()}
        for k in ("status", "machine", "site", "map_time", "start_time",
                  "end_time", "retries", "ready_time"):
            np.testing.assert_array_equal(log[k], ref[k].astype(log[k].dtype),
                                          err_msg=f"{heuristic} {i}: {k}")


@pytest.mark.parametrize("heuristic", ["ELARE", "FELARE"])
def test_single_trace_matches_jax(heuristic):
    """``simulate`` on one trace (no batch dim) gives the JAX engine's
    single-trace results, every observer at once."""
    tr = _traces()[1]
    obs = ("task_log", "timeline", "fairness_trajectory", "energy_budget")
    jm, jaux = jengine.simulate(tr, SPEC, heuristic, observers=obs)
    tm, taux = tengine.simulate(_one(tr), TSPEC, heuristic, observers=obs,
                                device=CPU)
    assert_metrics_equal(jm, tm, heuristic)
    assert_aux_equal(jaux, taux, heuristic)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("fleet,dispatcher", [
    ("paper_x2", "fair_spill"),      # block fold
    ("tiered_x4", "least_queued"),   # masked fold
])
def test_observers_on_federations(fleet, dispatcher, fused):
    """task_log (site included) and the per-site timeline on the block
    and the masked fold."""
    obs_j = ("task_log", jobs.Timeline(per_site=True))
    obs_t = ("task_log", tobs.Timeline(per_site=True))
    jm, jaux = _jax_observed("FELARE", obs_j, fleet, dispatcher)
    tm, taux = _port_observed("FELARE", obs_t, fleet, dispatcher, fused)
    assert_metrics_equal(jm, tm, fleet, _fleet(fleet).n_machines)
    wide = _fleet(fleet).n_machines > 8
    assert_aux_equal(jaux, taux, fleet,
                     close={("timeline", "e_idle")} if wide else ())
    assert taux["timeline"]["site_qlen"].shape == (3, 64,
                                                   _fleet(fleet).n_sites)
    assert (taux["task_log"]["site"] >= 0).all()


# ----------------------------------------------------------------- timeline
@pytest.mark.parametrize("per_site", [False, True], ids=["flat", "per_site"])
@pytest.mark.parametrize("K", [64, 48])
def test_timeline_matches_jax(K, per_site):
    """K = 48 is not a power of two: the bucket width is the horizon times
    the float32 reciprocal of K, as XLA's code forms it."""
    jm, jaux = _jax_observed("FELARE", (jobs.Timeline(K, per_site=per_site),
                                        jobs.FairnessTrajectory(K)))
    tm, taux = _port_observed("FELARE", (tobs.Timeline(K, per_site=per_site),
                                         tobs.FairnessTrajectory(K)))
    assert_aux_equal(jaux, taux, f"K={K}")


def test_timeline_final_bucket_matches_metrics():
    m, aux = _port_observed("FELARE", ("timeline", "fairness_trajectory"))
    tl = {k: v.numpy() for k, v in aux["timeline"].items()}
    np.testing.assert_array_equal(tl["completed"][:, -1],
                                  m.completed_by_type.numpy())
    np.testing.assert_array_equal(tl["arrived"][:, -1],
                                  m.arrived_by_type.numpy())
    np.testing.assert_array_equal(tl["e_dyn"][:, -1], m.energy_dynamic)
    # cumulative series are monotone non-decreasing after forward-fill
    assert np.all(np.diff(tl["e_dyn"], axis=1) >= 0)
    assert np.all(np.diff(tl["completed"].sum(-1), axis=1) >= 0)
    # end-state is drained: no queued/running tasks in the last bucket
    assert np.all(tl["qlen"][:, -1] == 0) and np.all(tl["running"][:, -1] == 0)
    ft = {k: v.numpy() for k, v in aux["fairness_trajectory"].items()}
    assert ft["suffered"].shape == (3, 64, SPEC.n_task_types)
    assert np.all((ft["cr"] >= 0) & (ft["cr"] <= 1))


def test_bucket_index_and_forward_fill_match_jax():
    """A finished replicate's ``now = inf`` lands in the last bucket
    (clamped in float, no undefined cast); forward_fill equals the
    reference's scan on random series."""
    width = torch.tensor([0.5, 0.5, 0.5, 2.0])
    now = torch.tensor([0.0, 3.9, math.inf, 1e30])
    assert tobs.bucket_index(now, width, 8).tolist() == [0, 7, 7, 7]
    r = np.random.default_rng(0)
    touched = r.random((5, 12)) < 0.3
    touched[0] = False
    series = {"a": r.integers(0, 9, (5, 12, 3)).astype(np.int32),
              "b": r.random((5, 12)).astype(np.float32)}
    init = {"a": np.zeros(3, np.int32), "b": np.float32(1.0)}
    got = tobs.forward_fill(torch.as_tensor(touched),
                            {k: torch.as_tensor(v) for k, v in series.items()},
                            {k: torch.as_tensor(v) for k, v in init.items()})
    for b in range(5):
        want = jobs.forward_fill(jnp.asarray(touched[b]),
                                 {k: jnp.asarray(v[b])
                                  for k, v in series.items()},
                                 {k: jnp.asarray(v) for k, v in init.items()})
        for k in series:
            np.testing.assert_array_equal(got[k][b].numpy(),
                                          np.asarray(want[k]))


# ----------------------------------------------------- fairness_trajectory
@pytest.mark.parametrize("factor", [None, 0.0], ids=["inherited", "explicit"])
def test_fairness_trajectory_matches_jax(factor):
    """On a lenient system (f = 4) the inherited factor samples the mask
    the mapper consulted; an explicit 0.0 is a counterfactual."""
    jspec = japi.paper_system(fairness_factor=4.0)
    tspec = dataclasses.replace(TSPEC, fairness_factor=4.0)
    trs = _traces()
    jm, jaux = jengine.simulate_batch(
        _batch(trs), jspec, "FELARE",
        observers=(jobs.FairnessTrajectory(fairness_factor=factor),))
    tm, taux = tengine.simulate_batch(
        stack_traces(trs), tspec, "FELARE", device=CPU,
        observers=(tobs.FairnessTrajectory(fairness_factor=factor),))
    assert_metrics_equal(jm, tm, f"factor={factor}")
    assert_aux_equal(jaux, taux, f"factor={factor}")


def test_fairness_trajectory_inherits_engine_factor():
    """MM ignores the mask, so the events are identical across f: only
    the observer's sampling can differ, and a lenient f shows fewer
    suffered samples."""
    tr = stack_traces(_traces(150))
    fracs = {}
    for f in (0.0, 4.0):
        spec = dataclasses.replace(TSPEC, fairness_factor=f)
        _, aux = tengine.simulate_batch(tr, spec, "MM", device=CPU,
                                        observers=("fairness_trajectory",))
        fracs[f] = aux["fairness_trajectory"]["suffered"].float().mean()
    assert fracs[4.0] < fracs[0.0]
    _, aux = tengine.simulate_batch(
        tr, dataclasses.replace(TSPEC, fairness_factor=4.0), "MM",
        device=CPU, observers=(tobs.FairnessTrajectory(fairness_factor=0.0),))
    assert aux["fairness_trajectory"]["suffered"].float().mean() == fracs[0.0]


# ------------------------------------------------------------ energy budget
@functools.lru_cache(maxsize=None)
def _budget(heuristic):
    """0.4 x the least unbudgeted total energy of the three traces."""
    m = jengine.simulate_batch(_batch(_traces(200)), SPEC, heuristic)
    total = np.asarray(m.energy_dynamic) + np.asarray(m.energy_idle)
    return float(0.4 * total.min())


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("heuristic", ["ELARE", "FELARE"])
def test_energy_budget_matches_jax(heuristic, fused):
    """The halted runs give the JAX engine's Metrics, t_exhausted and
    task_log, bit for bit."""
    cap = _budget(heuristic)
    trs = _traces(200)
    jm, jaux = jengine.simulate_batch(
        _batch(trs), SPEC, heuristic,
        observers=(jobs.EnergyBudget(capacity=cap), "task_log"))
    tm, taux = tengine.simulate_batch(
        stack_traces(trs), TSPEC, heuristic, use_fused_map=fused,
        device=CPU, observers=(tobs.EnergyBudget(capacity=cap), "task_log"))
    assert bool(taux["energy_budget"]["exhausted"].all())
    assert_metrics_equal(jm, tm, heuristic)
    assert_aux_equal(jaux, taux, heuristic)
    # never-admitted tasks were never dispatched
    log = taux["task_log"]
    assert (log["site"][log["status"] == 0] == -1).all()


def test_energy_budget_halts_admission():
    trs = _traces(200)
    tr = stack_traces(trs)
    m = tengine.simulate_batch(tr, TSPEC, "ELARE", device=CPU)
    total = m.energy_dynamic + m.energy_idle
    capacity = float(0.5 * total.min())
    mb, aux = tengine.simulate_batch(
        tr, TSPEC, "ELARE", device=CPU,
        observers=(tobs.EnergyBudget(capacity=capacity),))
    eb = aux["energy_budget"]
    assert bool(eb["exhausted"].all())
    assert bool((eb["t_exhausted"] < m.makespan).all())
    assert bool((mb.completed_by_type.sum(1)
                 < m.completed_by_type.sum(1)).all())
    # total energy within one event's energy of capacity
    e_max = max(float(np.max(t.exec_actual)) for t in trs)
    slack = (float(np.max(SPEC.p_dyn)) * e_max * SPEC.n_machines
             + float(np.sum(SPEC.p_idle)) * e_max)
    assert bool(((mb.energy_dynamic + mb.energy_idle)
                 <= capacity + slack).all())
    # accounting stays conserved for everything that was admitted
    torch.testing.assert_close(
        mb.completed_by_type + mb.missed_by_type + mb.cancelled_by_type,
        mb.arrived_by_type, rtol=0, atol=0)


def test_energy_budget_unset_is_inert():
    """capacity=inf never gates: Metrics bit-identical to a run without
    the observer."""
    tr = stack_traces(_traces(120))
    m = tengine.simulate_batch(tr, TSPEC, "FELARE", device=CPU)
    mb, aux = tengine.simulate_batch(tr, TSPEC, "FELARE", device=CPU,
                                     observers=("energy_budget",))
    for name in m._fields:
        assert torch.equal(getattr(m, name), getattr(mb, name)), name
    assert not bool(aux["energy_budget"]["exhausted"].any())
    assert not tobs.EnergyBudget().is_dynamic
    assert tobs.EnergyBudget(capacity=10.0).is_dynamic


def test_energy_budget_through_run_sweep():
    """The budget flows through the batched sweep; a tight budget
    completes fewer tasks."""
    base = dict(rates=(4.0,), reps=2, n_tasks=100, heuristics=("ELARE",),
                seed=0)
    free = texp.run_sweep(texp.SweepSpec(**base), device=CPU)
    total = float(free.energy_traces.max())
    tight = texp.run_sweep(texp.SweepSpec(
        **base, observers=(tobs.EnergyBudget(capacity=0.4 * total),)),
        device=CPU)
    assert np.all(tight.aux["energy_budget"]["exhausted"])
    assert (tight.metrics.completed_by_type.sum()
            < free.metrics.completed_by_type.sum())


# ----------------------------------------------------- batching and sweeps
def test_batched_aux_matches_sequential():
    """The freeze covers the aux: run_sweep's stacked aux equals each
    trace simulated alone, and the observers change no metric."""
    spec = texp.SweepSpec(rates=(2.0, 5.0), reps=2, n_tasks=60,
                          heuristics=("MM", "FELARE"), seed=3,
                          observers=("timeline", "task_log"))
    res = texp.run_sweep(spec, device=CPU)
    bare = texp.run_sweep(dataclasses.replace(spec, observers=()),
                          device=CPU)
    for a, b in zip(res.metrics, bare.metrics):
        np.testing.assert_array_equal(a, b)
    stacked = spec.resolve_scenario().stack(
        spec.seed, spec.rates, spec.reps, spec.n_tasks,
        spec.resolve_system().eet, device=CPU)
    for h_i, h in enumerate(spec.heuristics):
        for r_i in range(len(spec.rates)):
            for k in range(spec.reps):
                one = type(stacked)(*(x[r_i, k] for x in stacked))
                _, aux = tengine.simulate(one, spec.resolve_system(), h,
                                          observers=spec.observers,
                                          device=CPU)
                for obname, obaux in aux.items():
                    for leaf, arr in obaux.items():
                        np.testing.assert_array_equal(
                            arr.numpy(), res.aux[obname][leaf][h_i, r_i, k],
                            err_msg=f"{h} r{r_i} k{k} {obname}.{leaf}")


def test_no_observer_simulate_returns_bare_metrics():
    tr = _one(_traces(50)[0])
    m = tengine.simulate(tr, TSPEC, "ELARE", device=CPU)
    assert hasattr(m, "completed_by_type")  # Metrics, not (Metrics, aux)
    m2, aux = tengine.simulate(tr, TSPEC, "ELARE", device=CPU,
                               observers=("task_log",))
    assert torch.equal(m.completed_by_type, m2.completed_by_type)
    assert set(aux) == {"task_log"}


def test_run_sweep_aux_shapes_and_strict_json(tmp_path):
    """Aux leaves stack to (H, R, K, ...); inf leaves land as null in
    observers.json, never the non-standard Infinity token."""
    res = texp.run_sweep(texp.SweepSpec(
        rates=(3.0, 5.0), reps=2, n_tasks=40, heuristics=("MM", "ELARE"),
        observers=("energy_budget", "timeline", "task_log")), device=CPU)
    assert res.aux["timeline"]["completed"].shape == (2, 2, 2, 64, 4)
    assert res.aux["task_log"]["map_time"].shape == (2, 2, 2, 40)
    assert res.aux["energy_budget"]["t_exhausted"].shape == (2, 2, 2)
    paths = res.save(tmp_path)
    text = paths["observers_json"].read_text()
    assert "Infinity" not in text and "NaN" not in text
    payload = json.loads(text)
    assert payload["energy_budget"]["t_exhausted"][0][0] == [None, None]
    rows = (tmp_path / "timeline.csv").read_text().splitlines()
    assert len(rows) == 1 + 2 * 2 * 2 * 64


def test_timeline_artifacts_written(tmp_path, capsys):
    out = tmp_path / "artifacts"
    tsweep.main(["--device", "cpu", "--rates", "3", "--reps", "2",
                 "--tasks", "50", "--heuristics", "MM",
                 "--observers", "timeline,task_log", "--out", str(out)])
    assert (out / "observers.json").exists()
    header = (out / "timeline.csv").read_text().splitlines()[0]
    assert header.startswith("heuristic,rate,rep,bucket,t,qlen")
    assert "observers" in json.loads((out / "sweep.json").read_text())["spec"]


def test_cli_list_observers_and_unknown_name(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--list-observers"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert len(out.splitlines()) == 6
    assert "timeline" in out and "energy_budget" in out and "health" in out
    assert "network" in out
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--device", "cpu", "--observers", "timeline,bogus"])
    assert e.value.code == 2
    assert "error: unknown observers ['bogus']" in capsys.readouterr().err


def test_custom_observer_end_to_end():
    """A user-defined observer (event counter) registers, rides through
    run_sweep, and comes back stacked under (H, R, K)."""

    @dataclasses.dataclass(frozen=True)
    class EventCount(tobs.Observer):
        name = "event_count"

        def init(self, trace, sysarr):
            return {"events": torch.zeros(trace.arrival.shape[0],
                                          dtype=torch.int32)}

        def on_event(self, stage, aux, st, trace, sysarr):
            if stage != "start":
                return aux
            return {"events": aux["events"] + 1}

    tobs.register("event_count", EventCount())
    try:
        res = texp.run_sweep(texp.SweepSpec(
            rates=(2.0, 4.0), reps=2, n_tasks=40,
            heuristics=("MM", "ELARE"), observers=("event_count",)),
            device=CPU)
        ev = res.aux["event_count"]["events"]
        assert ev.shape == (2, 2, 2)
        assert np.all(ev > 0)
    finally:
        tobs.unregister("event_count")


def test_observers_read_nothing_back():
    """No host sync in the observers or the engine's stages: the only
    read in the loop is the periodic ``active.any()`` check."""
    import repro_torch.core.observe.base as base
    import repro_torch.core.observe.energy as energy
    import repro_torch.core.observe.tasklog as tasklog
    import repro_torch.core.observe.timeline as timeline

    sources = [inspect.getsource(m) for m in (base, energy, tasklog,
                                              timeline)]
    sources += [inspect.getsource(f) for f in (
        tengine._stage_admit, tengine._halt_shutdown,
        tengine._next_event_time, tengine._freeze_aux)]
    for src in sources:
        for sync in (".item(", ".tolist(", "nonzero", ".cpu(", "bool(",
                     ".numpy("):
            assert sync not in src, sync
    loop = inspect.getsource(tengine._make_loop)
    assert loop.count("bool(") == 1 and "bool(active.any())" in loop
