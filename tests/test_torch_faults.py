"""The port's faults subsystem (``repro_torch.core.faults``, the engine's
``faults`` stage, health masking, ``with_backup``, ``health_aware``
re-routing and the ``health`` observer) against the JAX package's on
identical dyadic traces.

Mirrors ``tests/test_faults.py`` case for case where a case applies. The
port runs on the CPU, plain and with the kernel wrappers (their plain
versions here), batched and on one trace, and is held against the live
JAX engine (counters, makespans, energies, ``task_log`` with
``retries``, the ``health`` series) and event for event against
``repro.core.pyengine``. Every comparison is bit for bit on systems of
up to 8 machines (paper, paper_x2); on tiered_x4's 20 the energies are
held within rel 1e-6, since XLA's CPU code vectorizes its sums over more
than 8 machines (ROADMAP C).

Two reference tests have no counterpart: ``test_one_jit_trace_per_policy_
dispatcher_dynamics`` (the port compiles nothing per run; its place is
taken by :func:`test_faults_read_nothing_back`) and the pin of
``dynamics="none"`` to a frozen snapshot (the port is held against the
live reference, never a snapshot; :func:`test_dynamics_none_is_the_
unfaulted_loop` pins the degenerate case instead).
``test_elastic_launch_smoke``'s counterpart, held against the
reference's values, is in ``tests/test_torch_launch.py``.
"""
import functools
import inspect
import json
import pathlib
import sys

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro import experiments as jexp
from repro import scenarios as jscenarios
from repro.core import faults as jfaults
from repro.core import observe as jobs
from repro.core import pyengine
from repro_torch import experiments as texp
from repro_torch.core import engine as tengine
from repro_torch.core import faults, observe, policy
from repro_torch.core.types import CANCELLED, COMPLETED, MISSED
from repro_torch.experiments import sweep as tsweep
from test_torch_common import (
    CPU,
    jax_trace,
    jengine,
    port_spec,
    stack_traces,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "scripts"))
import torch_loop_ops  # noqa: E402  (the op counter of the loop)

torch.set_num_threads(1)

DYNAMICS = {
    "bernoulli_updown": ("BernoulliUpDown",
                         dict(p_fail=0.05, p_recover=0.3, seed=7)),
    "site_outage": ("SiteOutage",
                    dict(outages=((0, 0.25, 0.5), (1, 0.5, 0.625)))),
    "degrade": ("Degrade", dict(factor=2.0, p=0.5, seed=3)),
}


def _pair(cls_name: str, **kw):
    """The same dynamics on both sides: (JAX, port)."""
    return getattr(jfaults, cls_name)(**kw), getattr(faults, cls_name)(**kw)


@functools.lru_cache(maxsize=None)
def _fleet(name):
    return jscenarios.get_fleet(name).build()


@functools.lru_cache(maxsize=None)
def _traces(fleet, n=48, seeds=(3, 4), rate=4.0):
    return tuple(jax_trace(s, n, rate, _fleet(fleet).eet) for s in seeds)


def _batch(traces):
    return jax.tree.map(lambda *xs: np.stack(xs), *traces)


def _policies(heuristic, k=0):
    if not k:
        return heuristic, heuristic
    return jfaults.with_backup(heuristic, k), faults.with_backup(heuristic, k)


def assert_runs_equal(jout, tout, what, wide=False):
    """Metrics and every aux leaf of a JAX batch run equal the port's,
    dtypes included; energies within rel 1e-6 where ``wide``."""
    jm, jaux = jout
    tm, taux = tout
    for k in jm._fields:
        want, got = np.asarray(getattr(jm, k)), getattr(tm, k).numpy()
        if wide and k.startswith("energy"):
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {k}")
    assert set(taux) == set(jaux), what
    for ob, leaves in jaux.items():
        assert set(taux[ob]) == set(leaves), (what, ob)
        for k, v in leaves.items():
            want, got = np.asarray(v), taux[ob][k].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (what, ob, k)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{what}: {ob}.{k}")


def assert_matches_oracle(traces, spec, jpol, dispatcher, jdyn, taux, what):
    """The port's task_log equals ``pyengine``'s, event for event, per
    trace (the oracle sums energies in float64, so they are held within
    rel 1e-5)."""
    for i, tr in enumerate(traces):
        ref = pyengine.simulate(tr, spec, jpol, dispatcher=dispatcher,
                                dynamics=jdyn)
        log = {k: v[i].numpy() for k, v in taux["task_log"].items()}
        for k in ("status", "machine", "site", "retries", "map_time",
                  "start_time", "end_time"):
            np.testing.assert_array_equal(
                log[k], np.asarray(ref["task_log"][k]).astype(log[k].dtype),
                err_msg=f"{what} trace {i}: task_log.{k}")


def _run_both(fleet, jpol, tpol, dispatcher, dyn, observers=("task_log",),
              fused=False, traces=None):
    traces = traces or _traces(fleet)
    spec = _fleet(fleet)
    jout = jengine.simulate_batch(_batch(traces), spec, jpol,
                                  dispatcher=dispatcher, dynamics=dyn[0],
                                  observers=observers)
    tout = tengine.simulate_batch(
        stack_traces(traces), port_spec(spec), tpol, dispatcher=dispatcher,
        dynamics=dyn[1], observers=observers, use_fused_map=fused,
        use_fused_phase1=fused, device=CPU)
    return jout, tout


# -------------------------------------------------------------- registries
def test_builtin_dynamics_registered():
    names = faults.list_dynamics()
    assert names == ["bernoulli_updown", "degrade", "none", "site_outage"]
    assert names == jfaults.list_dynamics()
    for name in names:
        assert faults.is_registered(name)
        assert faults.describe(name) == jfaults.describe(name)
    assert isinstance(faults.get("NONE"), faults.NoDynamics)  # case-insens
    with pytest.raises(KeyError, match="choose from"):
        faults.get("nope")
    with pytest.raises(TypeError, match="MachineDynamics protocol"):
        faults.register("bad", object())
    faults.register("flaky", faults.BernoulliUpDown(p_fail=0.1))
    try:
        assert faults.resolve("FLAKY") == faults.BernoulliUpDown(p_fail=0.1)
    finally:
        faults.unregister("flaky")
    with pytest.raises(TypeError, match="MachineDynamics protocol"):
        faults.resolve(42)


def test_dynamics_json_round_trip_as_jax():
    for name, kw in [("NoDynamics", {}),
                     *DYNAMICS.values(),
                     ("Degrade", dict(factor=1.5, machines=(0, 3))),
                     ("SiteOutage", dict(outages=((1, 0.1, 0.9),),
                                         max_retries=5))]:
        jd, td = _pair(name, **kw)
        payload = json.loads(json.dumps(faults.to_json_dict(td)))
        assert payload == json.loads(json.dumps(jfaults.to_json_dict(jd)))
        assert faults.from_json_dict(payload) == td
    with pytest.raises(ValueError, match="unknown dynamics kind"):
        faults.from_json_dict({"kind": "nope"})


def test_dynamics_validation():
    with pytest.raises(ValueError, match="start < end"):
        faults.SiteOutage(outages=((0, 0.5, 0.25),))
    with pytest.raises(ValueError, match="factor"):
        faults.Degrade(factor=0.0)
    assert faults.SiteOutage(outages=[[1, 0, 1]]).outages == ((1, 0.0, 1.0),)
    assert faults.SiteOutage(
        outages=((0, 0.5, 0.75), (1, 0.25, 0.5))).wake_fracs() == \
        (0.25, 0.5, 0.75)


def test_hash_uniform_matches_jax_bit_for_bit():
    """The int64 hash equals the reference's uint32 one on a grid whose
    every product wraps 2**32, machine and step counters near 2**32
    included; the host mirror equals both."""
    machines = np.array([0, 1, 2, 7, 31, 12345, 2**31 - 1, 2**31,
                         2**32 - 2, 2**32 - 1], dtype=np.int64)
    steps = np.array([0, 1, 17, 4096, 65537, 2**31 + 5, 2**32 - 1],
                     dtype=np.int64)
    for seed in (0, 7, 123, 2**32 + 9, -1):
        got = faults.hash_uniform(torch.as_tensor(machines)[None, :],
                                  torch.as_tensor(steps)[:, None], seed)
        assert got.dtype == torch.float32
        want = np.asarray(jfaults.hash_uniform(
            jnp.asarray(machines.astype(np.uint32))[None, :],
            jnp.asarray(steps.astype(np.uint32))[:, None], seed))
        np.testing.assert_array_equal(got.numpy(), want)
        for i, s_ in enumerate(steps[:3]):
            for j, m in enumerate(machines):
                host = faults.hash_uniform_host(int(m), int(s_), seed)
                assert host == jfaults.hash_uniform_host(int(m), int(s_),
                                                         seed)
                assert host == want[i, j]


# ------------------------------------------------------------- degeneracy
def test_dynamics_none_is_the_unfaulted_loop():
    """``dynamics="none"`` (and ``NoDynamics``) run the loop without
    faults: the same final state, no health field, and not one op more
    per iteration (counted as ``scripts/torch_loop_ops.py`` counts)."""
    spec = port_spec(_fleet("paper_x2"))
    sysarr = spec.as_torch(CPU)
    tr = stack_traces(_traces("paper_x2"))

    def run(dyn):
        loop = tengine._make_loop(
            policy.get("FELARE"), sysarr, queue_size=spec.queue_size,
            dispatcher="fair_spill", site_of_machine=spec.site_of_machine,
            dynamics=dyn)
        return loop(tr)[0]

    base = run(None)
    for dyn in ("none", faults.NoDynamics(max_retries=9)):
        got = run(dyn)
        assert got.alive is None and got.retries is None
        for a, b, name in zip(got, base, base._fields):
            assert (a is None and b is None) or torch.equal(a, b), name
    pol = policy.with_fused_map("FELARE")
    # the first call also fills the dispatcher's cache of hash homes
    counts = [torch_loop_ops.ops_per_iteration(
        "paper_x2", pol, dispatcher="fair_spill", dynamics=dyn)
        for dyn in (None, None, "none")]
    assert counts[1] == counts[2]


def test_with_backup_inert_without_dynamics():
    tr = stack_traces(_traces("paper_x2"))
    spec = port_spec(_fleet("paper_x2"))
    base = tengine.simulate_batch(tr, spec, "FELARE", device=CPU)
    for k in (1, 2):
        wrapped = tengine.simulate_batch(
            tr, spec, faults.with_backup("FELARE", k=k), device=CPU,
            use_fused_map=True)
        for a, b, f in zip(base, wrapped, base._fields):
            assert torch.equal(a, b), f


def test_with_backup_validation_and_describe():
    with pytest.raises(ValueError, match="k must be >= 1"):
        faults.with_backup("FELARE", k=0)
    with pytest.raises(TypeError, match="mapping policy"):
        faults.with_backup(42)
    pol = faults.with_backup("FELARE", k=2)
    assert pol.backup_k == 2
    assert tuple(pol.describe()) == tuple(
        jfaults.with_backup("FELARE", k=2).describe())
    # the fused wrappers keep the backup wrapper outermost
    fused = tengine._resolve_policy(pol, True, True)
    assert isinstance(fused, faults.BackupPolicy) and fused.backup_k == 2
    assert isinstance(fused.base, policy.FusedMapPolicy)
    phase1 = policy.with_fused_phase1(faults.with_backup("ELARE", k=1))
    assert phase1.backup_k == 1
    assert phase1.base.nominator.impl is not None


# ---------------------------------------------------------- JAX and oracle
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("kind", list(DYNAMICS))
@pytest.mark.parametrize("heuristic", ["ELARE", "FELARE"])
def test_faulty_runs_match_jax_and_oracle(heuristic, kind, fused):
    """paper_x2 under failures, ``sticky`` and ``health_aware``: Metrics
    and task_log (retries included) bit for bit with the JAX engine, and
    event for event with ``pyengine``, the failure draws and the outage
    window edges included."""
    dyn = _pair(*DYNAMICS[kind][:1], **DYNAMICS[kind][1])
    for dispatcher in ("sticky", "health_aware"):
        what = f"{heuristic}/{dispatcher}/{kind}"
        jout, tout = _run_both("paper_x2", heuristic, heuristic, dispatcher,
                               dyn, fused=fused)
        assert_runs_equal(jout, tout, what)
        if not fused:
            assert_matches_oracle(_traces("paper_x2"), _fleet("paper_x2"),
                                  heuristic, dispatcher, dyn[0], tout[1],
                                  what)
        if kind != "degrade":
            assert tout[1]["task_log"]["retries"].sum() > 0, what


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("heuristic,k", [("ELARE", 1), ("FELARE", 1),
                                         ("FELARE", 2)])
def test_backup_failover_matches_jax_and_oracle(heuristic, k, fused):
    """``with_backup(k)`` under churn and under an outage that kills a
    whole site at once (its orphans contend for the other site's slots),
    inside the fused wrappers: bit for bit with the JAX engine, event for
    event with ``pyengine``."""
    jpol, tpol = _policies(heuristic, k)
    for kind in ("bernoulli_updown", "site_outage"):
        dyn = _pair(DYNAMICS[kind][0], **DYNAMICS[kind][1])
        what = f"{heuristic}+backup{k}/{kind}"
        jout, tout = _run_both("paper_x2", jpol, tpol, "sticky", dyn,
                               fused=fused)
        assert_runs_equal(jout, tout, what)
        if not fused:
            assert_matches_oracle(_traces("paper_x2"), _fleet("paper_x2"),
                                  jpol, "sticky", dyn[0], tout[1], what)


def _sequential_failover(bks, orphan, alive, qlen, Q):
    """The reference's failover scan, one replicate, in plain Python."""
    M, k = bks.shape
    qlen = list(qlen)
    target, slot = [-1] * M, [0] * M
    for m in range(M):
        if not orphan[m]:
            continue
        for b in bks[m]:
            if b >= 0 and alive[b] and qlen[b] < Q:
                target[m], slot[m] = int(b), qlen[b]
                qlen[b] += 1
                break
    return target, slot


@pytest.mark.parametrize("k", [1, 2, 3])
def test_failover_scan_matches_the_sequential_scan(k):
    """The engine's failover (a ranking at k = 1, a scan over machines
    above) equals the reference's sequential scan on random events where
    many orphans name the same few backups (contention for the last
    slots) and some backups are dead or -1."""
    r = np.random.default_rng(k)
    B, M, N, Q = 64, 8, 40, 2
    backup = torch.as_tensor(r.integers(-1, 3, (B, N, k)))
    vict = torch.as_tensor(r.integers(0, N, (B, M)))
    orphan = torch.as_tensor(r.random((B, M)) < 0.7)
    alive = torch.as_tensor(r.random((B, M)) < 0.8)
    qlen = torch.as_tensor(r.integers(0, Q + 1, (B, M)))
    h = tengine._Health(None, 3, k, (0,) * M, 1, torch.zeros(M), None, None,
                        torch.arange(M)[None, :] < torch.arange(M)[:, None])
    target, slot = tengine._failover(backup, vict, orphan, alive, qlen, Q, h)
    contended = 0
    for b in range(B):
        bks = backup[b][vict[b]].numpy()
        want_t, want_s = _sequential_failover(bks, orphan[b].numpy(),
                                              alive[b].numpy(),
                                              qlen[b].numpy(), Q)
        np.testing.assert_array_equal(target[b].numpy(), want_t)
        moved = np.asarray(want_t) >= 0
        np.testing.assert_array_equal(slot[b].numpy()[moved],
                                      np.asarray(want_s)[moved])
        first = [row[0] for row, o in zip(bks, orphan[b]) if o and row[0] >= 0]
        contended += len(first) > len(set(first))
    assert contended > B // 2


def test_outage_orphans_more_than_one_event_admits():
    """An outage that orphans more tasks in one event than any event
    admits: the plain balance walk's bound grows by the orphans
    (``health_aware`` and ``least_queued`` on the plain walk), and the
    runs equal the JAX engine's."""
    traces = _traces("paper_x2", n=80, seeds=(5, 6), rate=8.0)
    dyn = _pair("SiteOutage", outages=((0, 0.3, 0.6),))
    bound = tengine._max_admissions(stack_traces(traces).arrival)
    for dispatcher in ("health_aware", "least_queued"):
        jout, tout = _run_both("paper_x2", "FELARE", "FELARE", dispatcher,
                               dyn, traces=traces)
        assert_runs_equal(jout, tout, dispatcher)
        # site 0 dies once, so every orphan comes from that one event
        orphans = (tout[1]["task_log"]["retries"] > 0).sum(1)
        assert int(orphans.min()) > bound, (orphans, bound)


@pytest.mark.parametrize("fleet", ["paper", "paper_x2"])
def test_degrade_factor_not_a_power_of_two(fleet):
    """Stragglers at 1.3 x: the reference's compiled code contracts
    ``now + e * slowdown`` into one rounding, as the port's start stage
    does; bit for bit, ELARE on ``phase1_map`` and FELARE on the map
    kernels (their plain versions here)."""
    dyn = _pair("Degrade", factor=1.3, machines=(1,))
    for heuristic in ("ELARE", "FELARE"):
        jout, tout = _run_both(fleet, heuristic, heuristic, "sticky", dyn,
                               fused=True)
        assert_runs_equal(jout, tout, f"{fleet}/{heuristic}")


@pytest.mark.parametrize("kind,dispatcher", [
    ("bernoulli_updown", "least_queued"), ("site_outage", "health_aware"),
    ("site_outage", "min_eet")])
def test_masked_fold_matches_jax(kind, dispatcher):
    """tiered_x4 (four unequal sites, the masked fold): the site views'
    tables are folded from the health-masked EET at every event, and
    ``min_eet`` reads per-replicate site minima."""
    dyn = _pair(*DYNAMICS[kind][:1], **DYNAMICS[kind][1])
    traces = _traces("tiered_x4", n=64, rate=12.0)
    jout, tout = _run_both("tiered_x4", "FELARE", "FELARE", dispatcher,
                           dyn, traces=traces, fused=True)
    assert_runs_equal(jout, tout, f"tiered_x4/{dispatcher}", wide=True)


@pytest.mark.parametrize("heuristic,kind,fused", [
    ("FELARE", "bernoulli_updown", True), ("ELARE", "degrade", True),
    ("MM", "bernoulli_updown", False)])
def test_flat_faults_match_jax(heuristic, kind, fused):
    """The flat paper system: the map kernels' EET is one table per
    replicate under health, and orphans go back to site 0."""
    dyn = _pair(*DYNAMICS[kind][:1], **DYNAMICS[kind][1])
    jout, tout = _run_both("paper", heuristic, heuristic, "sticky", dyn,
                           fused=fused)
    assert_runs_equal(jout, tout, f"paper/{heuristic}/{kind}")


def test_batched_equals_single_trace():
    """Each replicate keeps its own event counter, so the failure draws of
    a batched run are each trace's own: every row equals ``simulate`` on
    that trace alone."""
    traces = _traces("paper_x2", seeds=(3, 4, 8))
    spec = port_spec(_fleet("paper_x2"))
    dyn = faults.BernoulliUpDown(p_fail=0.05, p_recover=0.3, seed=7)
    obs = ("task_log", "health")
    bm, baux = tengine.simulate_batch(stack_traces(traces), spec, "FELARE",
                                      dispatcher="health_aware", dynamics=dyn,
                                      observers=obs, device=CPU)
    for i, tr in enumerate(traces):
        one = stack_traces([tr])
        m, aux = tengine.simulate(type(one)(*(x[0] for x in one)), spec,
                                  "FELARE", dispatcher="health_aware",
                                  dynamics=dyn, observers=obs, device=CPU)
        for a, b, f in zip(m, bm, m._fields):
            assert torch.equal(a, b[i]), (i, f)
        for ob, leaves in aux.items():
            for k, v in leaves.items():
                assert torch.equal(v, baux[ob][k][i]), (i, ob, k)
    jm, jaux = jengine.simulate(traces[1], _fleet("paper_x2"), "FELARE",
                                dispatcher="health_aware",
                                dynamics=jfaults.BernoulliUpDown(
                                    p_fail=0.05, p_recover=0.3, seed=7),
                                observers=obs)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(bm, k)[1].numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


# ------------------------------------------------------- safety properties
@given(seed=st.integers(0, 1000), rate=st.floats(2.0, 8.0),
       dispatcher=st.sampled_from(["sticky", "least_queued", "fair_spill",
                                   "health_aware"]))
@settings(max_examples=4, deadline=None)
def test_no_task_starts_on_a_dead_machine(seed, rate, dispatcher):
    """Under a scheduled outage, no task starts on a machine inside its
    site's window, and retries stay within max_retries (+1 for the
    cancelled ones)."""
    dyn = faults.SiteOutage(outages=((0, 0.25, 0.5),), max_retries=2)
    spec = _fleet("paper_x2")
    tr = jax_trace(seed, 80, rate, spec.eet)
    _, aux = tengine.simulate_batch(
        stack_traces([tr]), port_spec(spec), "FELARE", dynamics=dyn,
        observers=("task_log",), dispatcher=dispatcher, device=CPU,
        use_fused_map=True)
    log = {k: v[0].numpy() for k, v in aux["task_log"].items()}
    horizon = np.float32(np.asarray(tr.deadline).max())
    t0 = np.float32(np.float32(0.25) * horizon)
    t1 = np.float32(np.float32(0.5) * horizon)
    sites = np.asarray(spec.site_of_machine)
    ran = np.isin(log["status"], (COMPLETED, MISSED)) & (log["machine"] >= 0)
    started = log["start_time"][ran]
    on_dead_site = sites[log["machine"][ran]] == 0
    assert not np.any(on_dead_site & (started >= t0) & (started < t1))
    surviving = log["status"] != CANCELLED
    assert log["retries"][surviving].max(initial=0) <= dyn.max_retries
    assert log["retries"].max() <= dyn.max_retries + 1


def test_full_blackout_cancels_everything_and_terminates():
    """Both sites dark for the whole trace: every task dies by retry
    exhaustion or as hopeless, nothing ever runs, and the loop ends."""
    spec = _fleet("paper_x2")
    tr = jax_trace(0, 30, 4.0, spec.eet)
    dyn = _pair("SiteOutage", outages=((0, 0.0, 10.0), (1, 0.0, 10.0)),
                max_retries=1)
    jout, tout = _run_both("paper_x2", "FELARE", "FELARE", "health_aware",
                           dyn, traces=(tr,), fused=True)
    assert_runs_equal(jout, tout, "blackout")
    m, aux = tout
    assert int(m.completed_by_type.sum()) == 0
    assert bool((aux["task_log"]["machine"] == -1).all())
    assert int(m.cancelled_by_type.sum()) == 30


# ------------------------------------------------------- health observer
def test_health_observer_matches_jax():
    """The health series bit for bit with the JAX observer under an
    outage, and flat without dynamics."""
    spec = _fleet("paper_x2")
    traces = _traces("paper_x2", n=100, seeds=(2, 9), rate=5.0)
    dyn = _pair("SiteOutage", outages=((0, 0.25, 0.5),))
    jout, tout = _run_both("paper_x2", "FELARE", "FELARE", "health_aware",
                           dyn, observers=("health", "task_log"),
                           traces=traces, fused=True)
    assert_runs_equal(jout, tout, "health")
    h = {k: v.numpy() for k, v in tout[1]["health"].items()}
    M, F = spec.n_machines, spec.n_sites
    assert h["site_healthy"].shape == (2, 64, F)
    assert h["healthy"].min() == M // 2 and h["healthy"].max() == M
    assert not h["site_alive"][:, :, 0].all()
    assert h["site_alive"][:, :, 1].all()
    np.testing.assert_array_equal(h["site_healthy"].sum(-1), h["healthy"])
    assert np.all(np.diff(h["orphans"], axis=1) >= 0)
    assert np.all(h["orphans"][:, -1] > 0)
    # with no dynamics the series are flat
    jm, jaux = jengine.simulate_batch(_batch(traces), spec, "FELARE",
                                      observers=("health",))
    tm, taux = tengine.simulate_batch(stack_traces(traces), port_spec(spec),
                                      "FELARE", observers=("health",),
                                      device=CPU)
    assert_runs_equal((jm, jaux), (tm, taux), "health, no dynamics")
    assert bool((taux["health"]["healthy"] == M).all())
    assert not bool(taux["health"]["orphans"].any())


def test_health_observer_registered_and_round_trips():
    assert "health" in observe.list_observers()
    assert observe.describe("health") == jobs.describe("health")
    ob = observe.Health(n_buckets=16)
    d = json.loads(json.dumps(ob.to_json_dict()))
    assert d == jobs.Health(n_buckets=16).to_json_dict()
    assert observe.from_json_dict(d) == ob


# ------------------------------------------------------------- no syncs
def test_faults_read_nothing_back():
    """No host sync in the dynamics, the faults stage, the failover scan,
    the backup nomination or the health branches of the other stages."""
    import repro_torch.core.faults.base as base
    import repro_torch.core.faults.builtins as builtins
    import repro_torch.core.observe.health as health

    sources = [inspect.getsource(m) for m in (base, builtins, health)]
    sources += [inspect.getsource(f) for f in (
        tengine._stage_faults, tengine._failover, tengine._enqueue,
        tengine._health_eet, tengine._nominate_backups, tengine._site_eet,
        tengine._stage_dispatch, tengine._map_action, tengine._stage_start,
        tengine._next_event_time)]
    for src in sources:
        for sync in (".item(", ".tolist(", "nonzero", ".cpu(", "bool(",
                     ".numpy("):
            assert sync not in src, sync


# ------------------------------------------------------------ CLI + spec
def test_cli_faulty_sweep_writes_artifacts(tmp_path, capsys):
    out = tmp_path / "faults"
    tsweep.main(["--device", "cpu", "--system", "paper_x2",
                 "--dispatcher", "health_aware", "--dynamics", "site_outage",
                 "--observers", "health", "--rates", "4.0", "--reps", "1",
                 "--tasks", "40", "--heuristics", "ELARE", "--fused-map",
                 "--out", str(out)])
    payload = json.loads((out / "sweep.json").read_text())
    assert payload["spec"]["dynamics"] == "site_outage"
    assert (out / "sweep.csv").exists()
    obs = json.loads((out / "observers.json").read_text())
    assert len(obs["health"]["healthy"][0][0][0]) == 64  # (H, R, K, 64)
    assert "dynamics=site_outage" in capsys.readouterr().out


def test_cli_rejects_unknown_dynamics(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--device", "cpu", "--dynamics", "nope"])
    assert e.value.code == 2
    assert "error: unknown dynamics 'nope'" in capsys.readouterr().err


def test_cli_list_dynamics(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--list-dynamics"])
    assert e.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4
    for name, line in zip(faults.list_dynamics(), out):
        assert line.startswith(name)


def test_spec_dynamics_validated_and_recorded_as_jax():
    with pytest.raises(ValueError, match="unknown dynamics"):
        texp.SweepSpec(dynamics="nope")
    with pytest.raises(ValueError, match="MachineDynamics"):
        texp.SweepSpec(dynamics=42)
    assert texp.SweepSpec(dynamics="Site_Outage").dynamics == "site_outage"
    kw = dict(system="paper_x2", dispatcher="health_aware", rates=(2.0,),
              reps=2, n_tasks=40, heuristics=("MM",))
    for jd, td in (("site_outage", "site_outage"),
                   _pair("SiteOutage", outages=((1, 0.1, 0.4),),
                         max_retries=5)):
        ours = texp.SweepSpec(**kw, dynamics=td)
        ref = jexp.SweepSpec(**kw, dynamics=jd)
        assert ours.to_json_dict()["dynamics"] == \
            ref.to_json_dict()["dynamics"]
        json.dumps(ours.to_json_dict())
    assert texp.SweepSpec().to_json_dict()["dynamics"] == "none"


def test_run_sweep_under_faults_matches_simulate_batch():
    """The sweep hands the dynamics to every heuristic: its Metrics are
    ``simulate_batch``'s on the same traces."""
    spec = texp.SweepSpec(system="paper_x2", rates=(4.0,), reps=2,
                          n_tasks=50, heuristics=("ELARE", "FELARE"),
                          dispatcher="health_aware", dynamics="site_outage",
                          use_fused_map=True)
    res = texp.run_sweep(spec, device=CPU)
    stacked = spec.resolve_scenario().stack(
        spec.seed, spec.rates, spec.reps, spec.n_tasks,
        spec.resolve_system().eet, device=CPU)
    flat = type(stacked)(*(x.reshape((-1,) + x.shape[2:]) for x in stacked))
    for h_i, h in enumerate(spec.heuristics):
        m = tengine.simulate_batch(flat, spec.resolve_system(), h,
                                   dispatcher="health_aware",
                                   dynamics="site_outage",
                                   use_fused_map=True, device=CPU)
        for a, f in zip(m, m._fields):
            np.testing.assert_array_equal(
                getattr(res.metrics, f)[h_i].reshape(a.shape), a.numpy(),
                err_msg=f"{h}: {f}")
    assert res.metrics.cancelled_by_type.sum() > 0
