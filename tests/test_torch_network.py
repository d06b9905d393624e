"""The port's network subsystem (``repro_torch.core.network``, the
engine's transfer accounting and in-transit landings, ``tier_aware``'s
link term and the ``network`` observer) against the JAX package's on
identical dyadic traces.

Mirrors ``tests/test_network.py`` case for case where a case applies.
The port runs on the CPU, plain and with the kernel wrappers (their
plain versions here), batched and on one trace, and is held against the
live JAX engine (counters, makespans, energies, ``task_log`` with
``ready_time``, the ``network`` series) and event for event against
``repro.core.pyengine``. Everything is bit for bit, with one exception:
under the default ``tiered`` matrices (0.1, 0.05, ...) the per-tier
transfer energy and the Metrics' energies are held within rel 1e-6. The
reference's compiled code adds an event's link energies into its
per-tier tally one task at a time, the port forms each tier's sum
first, and more than two links landing on one tier in one event round
apart in the last place (ROADMAP C). Under dyadic prices every order
gives the same float, and those runs are held bit for bit.

Two reference tests have no counterpart: the pin of ``network="none"``
to a frozen snapshot (the port is held against the live reference;
:func:`test_network_none_is_the_unnetworked_loop` pins the degenerate
case instead) and the scale smoke's one-trace-per-tuple count (the port
compiles nothing per run; :func:`test_network_reads_nothing_back` takes
its place).
"""
import functools
import inspect
import json
import pathlib
import sys

import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro import experiments as jexp
from repro import scenarios as jscenarios
from repro.core import faults as jfaults
from repro.core import network as jnet
from repro.core import observe as jobs
from repro.core import pyengine
from repro_torch import experiments as texp
from repro_torch import scenarios
from repro_torch.core import api, dispatch, faults, network, observe, policy
from repro_torch.core import engine as tengine
from repro_torch.core.types import (
    CANCELLED,
    PENDING,
    QUEUED,
    RUNNING,
    UNARRIVED,
)
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

ZERO3 = ((0.0, 0.0, 0.0),) * 3
# Dyadic prices: every sum of them is exact, in any order.
DYADIC = {
    "uniform_latency": dict(latency=0.25, energy=0.5),
    "tiered": dict(latency=((0.25, 0.5, 1.0), (0.5, 0.25, 0.5),
                            (1.0, 0.5, 0.0)),
                   energy=((0.125, 0.5, 2.0), (0.5, 0.125, 1.0),
                           (2.0, 1.0, 0.0)),
                   input_size=(1.0, 2.0, 0.5, 1.0)),
}
# The four dispatchers of the reference's oracle grid.
DISPATCHERS = ("tier_aware", "fair_spill", "min_eet", "sticky")


def _pair(kind: str, **kw):
    """The same network on both sides: (JAX, port)."""
    cls = {"uniform_latency": "UniformLatency", "tiered": "Tiered"}[kind]
    return getattr(jnet, cls)(**kw), getattr(network, cls)(**kw)


@functools.lru_cache(maxsize=None)
def _fleet(name):
    return jscenarios.get_fleet(name).build()


@functools.lru_cache(maxsize=None)
def _traces(fleet, n=60, seeds=(0, 3), rate=6.0):
    return tuple(jax_trace(s, n, rate, _fleet(fleet).eet) for s in seeds)


def _batch(traces):
    return jax.tree.map(lambda *xs: np.stack(xs), *traces)


def _net(name: str, dyadic: bool):
    """(JAX, port) network: the registered default, or its dyadic
    variant."""
    if dyadic:
        return _pair(name, **DYADIC[name])
    return jnet.get(name), network.get(name)


@functools.lru_cache(maxsize=None)
def _jax_run(fleet, heuristic, dispatcher, net_key, dyn_key=None,
             observers=("task_log", "network")):
    net = _net(*net_key)[0] if net_key else None
    dyn = _dynamics(dyn_key)[0] if dyn_key else None
    jpol = (jfaults.with_backup(heuristic[:-1], 1)
            if heuristic.endswith("+") else heuristic)
    return jengine.simulate_batch(_batch(_traces(fleet)), _fleet(fleet), jpol,
                                  dispatcher=dispatcher, network=net,
                                  dynamics=dyn, observers=observers)


def _port_run(fleet, heuristic, dispatcher, net_key, dyn_key=None,
              observers=("task_log", "network"), fused=False, traces=None):
    net = _net(*net_key)[1] if net_key else None
    dyn = _dynamics(dyn_key)[1] if dyn_key else None
    tpol = (faults.with_backup(heuristic[:-1], 1)
            if heuristic.endswith("+") else heuristic)
    return tengine.simulate_batch(
        stack_traces(traces or _traces(fleet)), port_spec(_fleet(fleet)),
        tpol, dispatcher=dispatcher, network=net, dynamics=dyn,
        observers=observers, use_fused_map=fused, device=CPU)


def _dynamics(key):
    kind, kw = key
    return (getattr(jfaults, kind)(**dict(kw)),
            getattr(faults, kind)(**dict(kw)))


#: The Metrics fields held within rel 1e-6: the idle energy over more
#: than 8 machines (tiered_x4's 20), and every energy where the link
#: prices are not dyadic or machine faults kill runs on 20 machines.
WIDE = ("energy_idle",)
ENERGIES = ("energy_dynamic", "energy_wasted", "energy_idle")
XFER = (("network", "xfer_energy"),)


def assert_runs_equal(jout, tout, what, close=(), close_aux=()):
    """Metrics and every aux leaf of a JAX batch run equal the port's,
    dtypes included; the Metrics fields in ``close`` and the aux leaves
    in ``close_aux`` (``(observer, leaf)``) within rel 1e-6."""
    jm, jaux = jout
    tm, taux = tout
    for k in jm._fields:
        want, got = np.asarray(getattr(jm, k)), getattr(tm, k).numpy()
        if k in close:
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
            if (ob, k) in close_aux:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           err_msg=f"{what}: {ob}.{k}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{what}: {ob}.{k}")


def assert_matches_oracle(traces, spec, heuristic, dispatcher, jnet_model,
                          taux, what, jdyn=None):
    """The port's task_log equals ``pyengine``'s, event for event, per
    trace, the ready times included."""
    for i, tr in enumerate(traces):
        ref = pyengine.simulate(tr, spec, heuristic, dispatcher=dispatcher,
                                dynamics=jdyn, network=jnet_model)
        log = {k: v[i].numpy() for k, v in taux["task_log"].items()}
        for k in ("status", "machine", "site", "retries", "map_time",
                  "start_time", "end_time", "ready_time"):
            np.testing.assert_array_equal(
                log[k], np.asarray(ref["task_log"][k]).astype(log[k].dtype),
                err_msg=f"{what} trace {i}: task_log.{k}")


# -------------------------------------------------------------- registries
def test_builtin_networks_registered():
    names = network.list_networks()
    assert names == ["none", "tiered", "uniform_latency"]
    assert names == jnet.list_networks()
    for name in names:
        assert network.is_registered(name)
        assert network.describe(name)
    for name in ("tiered", "uniform_latency"):
        assert network.describe(name) == jnet.describe(name)
    assert isinstance(network.get("NONE"), network.NoNetwork)  # case-insens
    assert network.get("Tiered") == network.Tiered()
    with pytest.raises(KeyError, match="choose from"):
        network.get("nope")
    with pytest.raises(TypeError, match="NetworkModel protocol"):
        network.register("bad", object())
    network.register("WAN", network.UniformLatency(latency=1.0))
    try:
        assert network.resolve("wan") == network.UniformLatency(latency=1.0)
    finally:
        network.unregister("wan")
    with pytest.raises(TypeError, match="NetworkModel protocol"):
        network.resolve(42)


def test_network_json_round_trip_as_jax():
    for kind, kw in [("uniform_latency", dict(latency=0.5, energy=0.25,
                                              salt=3)),
                     ("tiered", {}),
                     ("tiered", dict(input_size=(0.5, 1.0, 2.0, 4.0),
                                     salt=1)),
                     ("tiered", dict(latency=ZERO3, energy=ZERO3))]:
        jm, tm = _pair(kind, **kw)
        payload = json.loads(json.dumps(network.to_json_dict(tm)))
        assert payload == json.loads(json.dumps(jnet.to_json_dict(jm)))
        assert network.from_json_dict(payload) == tm
    none = network.NoNetwork()
    assert network.to_json_dict(none) == jnet.to_json_dict(jnet.NoNetwork())
    assert network.from_json_dict({"kind": "none"}) == none
    with pytest.raises(ValueError, match="unknown network kind"):
        network.from_json_dict({"kind": "nope"})


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", [
    lambda m: m.UniformLatency(latency=-0.1),
    lambda m: m.UniformLatency(energy=-1.0),
    lambda m: m.Tiered(latency=((0.0, 1.0),)),
    lambda m: m.Tiered(energy=((0.0, -1.0), (1.0, 0.0)),
                       latency=((0.0, 1.0), (1.0, 0.0))),
    lambda m: m.Tiered(latency=((0.0,),), energy=ZERO3),
    lambda m: m.Tiered(input_size=(1.0, -2.0)),
    lambda m: m.Tiered().cost_tables((0, 1, 3), 4),
    lambda m: m.Tiered(input_size=(1.0, 2.0)).cost_tables((0, 1, 2), 4),
], ids=["neg-latency", "neg-energy", "not-square", "neg-entry",
        "size-mismatch", "neg-input", "tier-out-of-range", "input-size"])
def test_network_validation_as_jax(case):
    """Each invalid model raises the reference's error, text included."""
    want = _error(lambda: case(jnet))
    assert want is not None
    assert _error(lambda: case(network)) == want


@pytest.mark.parametrize("tiers", [(0, 0, 0, 2), (1, 2, 1), (0, 0)],
                         ids=["0002", "121", "00"])
def test_cost_tables_equal_reference_byte_for_byte(tiers):
    models = [("uniform_latency", {}), ("uniform_latency", DYADIC[
        "uniform_latency"]), ("tiered", {}),
        ("tiered", dict(input_size=(0.5, 1.0, 2.0, 4.0))),
        ("tiered", dict(latency=((0.1, 0.3, 0.7), (0.3, 0.1, 0.9),
                                 (0.7, 0.9, 0.0)),
                        input_size=(0.3, 1.7, 2.9, 0.1)))]
    for kind, kw in models:
        jm, tm = _pair(kind, **kw)
        for want, got in zip(jm.cost_tables(tiers, 4),
                             tm.cost_tables(tiers, 4)):
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape == (4, len(tiers), len(tiers))
            assert got.tobytes() == want.tobytes(), (kind, kw)
            for t in range(4):
                assert np.all(np.diag(got[t]) == 0.0)
    for want, got in zip(jnet.NoNetwork().cost_tables(tiers, 4),
                         network.NoNetwork().cost_tables(tiers, 4)):
        assert got.tobytes() == want.tobytes()


def test_hash_origins_match_reference_bit_for_bit():
    """The device hash (int64 masked to 32 bits) and its host mirror
    equal the reference's uint32 hash and its host mirror, over task
    indices whose products wrap 2**32 many times."""
    n = 5000
    for salt in (0, 7, 123, 2**32 - 1, 2**32 + 5):
        for elig in ((0,), (0, 1, 2), (2, 5, 6, 11), tuple(range(15))):
            want = np.asarray(jnet.hash_origins(n, elig, salt % 2**32))
            got = network.hash_origins(n, elig, salt)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
            host = network.hash_origins_host(n, elig, salt)
            np.testing.assert_array_equal(host, want)
            np.testing.assert_array_equal(
                host, jnet.hash_origins_host(n, elig, salt % 2**32))
            assert set(host.tolist()) <= set(elig)


def test_origin_sites_lowest_tier_only():
    for tiers in ((0, 0, 0, 2), (1, 2, 1), (0, 0), (2,), (0,) * 15 + (2,)):
        assert network.origin_sites(tiers) == jnet.origin_sites(tiers)
    assert network.origin_sites((1, 2, 1)) == (0, 2)


# ------------------------------------------------------------- degeneracy
def test_network_none_is_the_unnetworked_loop():
    """``network="none"`` (and ``NoNetwork``) run the loop without a
    network: the same final state, no transfer field, the same Metrics
    and task_log as the default, and not one op more per iteration
    (counted as ``scripts/torch_loop_ops.py`` counts)."""
    spec = port_spec(_fleet("tiered_x4"))
    sysarr = spec.as_torch(CPU)
    tr = stack_traces(_traces("tiered_x4"))

    def run(net):
        loop = tengine._make_loop(
            policy.get("FELARE"), sysarr, queue_size=spec.queue_size,
            dispatcher="fair_spill", site_of_machine=spec.site_of_machine,
            network=net, tier_of_site=spec.tier_of_site)
        return loop(tr)[0]

    base = run(None)
    for net in ("none", network.NoNetwork()):
        got = run(net)
        assert got.ready is None and got.e_xfer is None
        for a, b, name in zip(got, base, base._fields):
            assert (a is None and b is None) or torch.equal(a, b), name
    outs = [tengine.simulate_batch(tr, spec, "FELARE", dispatcher="sticky",
                                   observers=("task_log",), network=net,
                                   device=CPU)
            for net in (None, "none")]
    for (ma, la), (mb, lb) in [outs]:
        for a, b, f in zip(ma, mb, ma._fields):
            assert torch.equal(a, b), f
        for k in la["task_log"]:
            assert torch.equal(la["task_log"][k], lb["task_log"][k]), k
        assert bool((la["task_log"]["ready_time"] == -1.0).all())
    pol = policy.with_fused_map("FELARE")
    # the first call also fills the dispatcher's cache of hash homes
    counts = [torch_loop_ops.ops_per_iteration(
        "tiered_x4", pol, dispatcher="fair_spill", network=net)
        for net in (None, None, "none")]
    assert counts[1] == counts[2]


@settings(deadline=None, max_examples=1)
@given(seed=st.integers(0, 31), rate=st.sampled_from([2.0, 4.0, 6.0]))
def test_zero_cost_tiered_is_bit_identical_to_no_network(seed, rate):
    """A tiered network whose matrices are all zero gives every Metrics
    field and every task_log field but ``ready_time`` of the run without
    a network, for every dispatcher x ELARE/FELARE: ready times collapse
    to dispatch times, transfer energy to zero, the events are the same."""
    tr = stack_traces([jax_trace(seed, 40, rate, _fleet("tiered_x4").eet)])
    spec = port_spec(_fleet("tiered_x4"))
    free = network.Tiered(latency=ZERO3, energy=ZERO3)
    for d in dispatch.list_dispatchers():
        for h in ("ELARE", "FELARE"):
            m0, a0 = tengine.simulate_batch(tr, spec, h, dispatcher=d,
                                            observers=("task_log",),
                                            device=CPU)
            m1, a1 = tengine.simulate_batch(tr, spec, h, dispatcher=d,
                                            observers=("task_log",),
                                            network=free, device=CPU,
                                            use_fused_map=h == "FELARE")
            for a, b, f in zip(m0, m1, m0._fields):
                assert torch.equal(a, b), f"{d}/{h}/{f}"
            for k in a0["task_log"]:
                if k != "ready_time":
                    assert torch.equal(a0["task_log"][k],
                                       a1["task_log"][k]), f"{d}/{h}/{k}"


def test_tier_aware_equals_min_eet_without_network():
    tr = stack_traces(_traces("tiered_x4"))
    spec = port_spec(_fleet("tiered_x4"))
    for h in ("ELARE", "FELARE"):
        a, la = tengine.simulate_batch(tr, spec, h, dispatcher="tier_aware",
                                       observers=("task_log",), device=CPU)
        b, lb = tengine.simulate_batch(tr, spec, h, dispatcher="min_eet",
                                       observers=("task_log",), device=CPU)
        for x, y, f in zip(a, b, a._fields):
            assert torch.equal(x, y), f"{h}/{f}"
        assert torch.equal(la["task_log"]["site"], lb["task_log"]["site"])


def test_tier_aware_scores_eet_plus_link_latency():
    """The score is the site's fastest EET plus the link's latency, one
    float32 add, lowest site on ties; per replicate under faults."""
    r = np.random.default_rng(0)
    B, N, S, M = 3, 50, 4, 8
    sites = (0, 0, 1, 1, 2, 2, 3, 3)
    eet = torch.as_tensor(np.round(r.uniform(1, 9, (S, M)) * 4) / 4,
                          dtype=torch.float32)
    lat = torch.as_tensor(r.choice([0.0, 0.25, 1.0, 3.0], (B, N, 4)),
                          dtype=torch.float32)
    types = torch.as_tensor(r.integers(0, S, (B, N)))

    def ctx(eet_t, xfer):
        return dispatch.DispatchContext(
            now=torch.zeros(B), unassigned=torch.ones(B, N, dtype=bool),
            task_type=types, deadline=torch.full((B, N), 100.0),
            qlen=torch.zeros(B, M, dtype=torch.int64),
            running=torch.zeros(B, M, dtype=bool),
            completed=torch.zeros(B, S, dtype=torch.int64),
            arrived=torch.zeros(B, S, dtype=torch.int64), eet=eet_t,
            site_of_machine=sites, n_sites=4, fairness_factor=1.0,
            xfer_lat=xfer)

    ta = dispatch.get("tier_aware")
    got = ta.dispatch(ctx(eet, lat))
    ems = np.stack([eet.numpy()[:, [m for m in range(M) if sites[m] == f]]
                    .min(1) for f in range(4)], 1)          # (S, F)
    score = ems[types.numpy()] + lat.numpy()
    np.testing.assert_array_equal(got.numpy(), score.argmin(-1))
    eet_b = eet.expand(B, S, M).clone()
    eet_b[1, :, :2] = 1e30                                   # site 0 dead
    got_b = ta.dispatch(ctx(eet_b, lat))
    assert not bool((got_b[1] == 0).any())
    np.testing.assert_array_equal(got_b[0].numpy(), got[0].numpy())
    assert torch.equal(ta.dispatch(ctx(eet, None)),
                       dispatch.get("min_eet").dispatch(ctx(eet, None)))


# ---------------------------------------------------------- JAX and oracle
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("heuristic", ["ELARE", "FELARE"])
@pytest.mark.parametrize("net,dyadic", [("uniform_latency", True),
                                        ("tiered", False),
                                        ("tiered", True)],
                         ids=["uniform_latency", "tiered",
                              "tiered-dyadic"])
def test_networked_runs_match_jax_and_oracle(net, dyadic, heuristic, fused):
    """tiered_x4 with a network, under tier_aware, fair_spill, min_eet and
    sticky: Metrics, task_log (ready_time included) and the network
    series bit for bit with the JAX engine (the default tiered matrices'
    energies within rel 1e-6), and task_log event for event with
    ``pyengine`` (under the registered models; the dyadic tiered variant
    prices the same links with other numbers)."""
    close, close_aux = (WIDE, ()) if dyadic else (ENERGIES, XFER)
    for d in DISPATCHERS:
        what = f"{net}/{heuristic}/{d}"
        jout = _jax_run("tiered_x4", heuristic, d, (net, dyadic))
        tout = _port_run("tiered_x4", heuristic, d, (net, dyadic),
                         fused=fused)
        assert_runs_equal(jout, tout, what, close, close_aux)
        if not fused and not (dyadic and net == "tiered"):
            assert_matches_oracle(_traces("tiered_x4"), _fleet("tiered_x4"),
                                  heuristic, d, _net(net, dyadic)[0],
                                  tout[1], what)


def test_links_are_paid_and_tasks_land_late():
    """The parity grid's runs are not degenerate: fair_spill and sticky
    pay cross-site links (energy spent, ready times past arrival, tasks
    in transit), tier_aware keeps most tasks on their free origin site."""
    arrival = torch.as_tensor(_batch(_traces("tiered_x4")).arrival)
    for d in ("sticky", "fair_spill"):
        m, aux = _port_run("tiered_x4", "FELARE", d, ("tiered", False))
        log = aux["task_log"]
        ran = log["status"] != UNARRIVED
        assert bool((log["ready_time"][ran] > arrival[ran]).any()), d
        assert float(aux["network"]["xfer_energy"][:, -1].sum()) > 0
        assert int(aux["network"]["in_transit"].max()) > 0
    base = _port_run("tiered_x4", "FELARE", "sticky", None)[0]
    paid = _port_run("tiered_x4", "FELARE", "sticky", ("tiered", False))[0]
    assert bool((paid.energy_dynamic > base.energy_dynamic).all())
    aware = _port_run("tiered_x4", "FELARE", "tier_aware", ("tiered", False))
    sticky = _port_run("tiered_x4", "FELARE", "sticky", ("tiered", False))
    assert float(aware[1]["network"]["xfer_energy"][:, -1].sum()) < float(
        sticky[1]["network"]["xfer_energy"][:, -1].sum())


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_uniform_latency_on_a_federation_of_one_tier(fused):
    """paper_x2 (both sites on the device tier, both origins) under
    uniform_latency with dyadic prices: bit for bit with the JAX engine
    for every dispatcher of the grid, and with ``pyengine``."""
    for d in DISPATCHERS:
        jout = _jax_run("paper_x2", "FELARE", d, ("uniform_latency", True))
        tout = _port_run("paper_x2", "FELARE", d, ("uniform_latency", True),
                         fused=fused)
        assert_runs_equal(jout, tout, f"paper_x2/{d}")
        if not fused:
            assert_matches_oracle(_traces("paper_x2"), _fleet("paper_x2"),
                                  "FELARE", d,
                                  _net("uniform_latency", True)[0], tout[1],
                                  f"paper_x2/{d}")


def test_flat_system_with_a_network():
    """One site: every link is the free diagonal, so the Metrics are the
    unnetworked run's and the ready times are the dispatch (admission)
    times, as the JAX engine stamps them."""
    jout = _jax_run("paper", "FELARE", None, ("uniform_latency", True),
                    observers=("task_log",))
    tout = _port_run("paper", "FELARE", None, ("uniform_latency", True),
                     observers=("task_log",), fused=True)
    assert_runs_equal(jout, tout, "paper")
    base = _port_run("paper", "FELARE", None, None, observers=())
    for a, b, f in zip(base, tout[0], base._fields):
        assert torch.equal(a, b), f


def test_batched_equals_single_trace():
    """Each replicate keeps its own links and landings: every row of a
    batched networked run equals ``simulate`` on that trace alone, and
    the JAX engine's single run."""
    traces = _traces("tiered_x4")
    spec = port_spec(_fleet("tiered_x4"))
    obs = ("task_log", "network")
    bm, baux = _port_run("tiered_x4", "FELARE", "fair_spill",
                         ("tiered", False), fused=True)
    for i, tr in enumerate(traces):
        one = stack_traces([tr])
        m, aux = tengine.simulate(type(one)(*(x[0] for x in one)), spec,
                                  "FELARE", dispatcher="fair_spill",
                                  network="tiered", observers=obs,
                                  device=CPU)
        for a, b, f in zip(m, bm, m._fields):
            assert torch.equal(a, b[i]), (i, f)
        for ob, leaves in aux.items():
            for k, v in leaves.items():
                assert torch.equal(v, baux[ob][k][i]), (i, ob, k)
    jm, jaux = jengine.simulate(traces[1], _fleet("tiered_x4"), "FELARE",
                                dispatcher="fair_spill", network="tiered",
                                observers=obs)
    for k in jm._fields:
        np.testing.assert_allclose(getattr(bm, k)[1].numpy(),
                                   np.asarray(getattr(jm, k)), rtol=1e-6,
                                   err_msg=k)
    for k, v in jaux["task_log"].items():
        np.testing.assert_array_equal(baux["task_log"][k][1].numpy(),
                                      np.asarray(v), err_msg=k)


# ------------------------------------------------------- network x faults
OUTAGE = ("SiteOutage", (("outages", ((0, 0.25, 0.5), (1, 0.5, 0.625))),))
CHURN = ("BernoulliUpDown", (("p_fail", 0.05), ("p_recover", 0.3),
                             ("seed", 7)))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("heuristic,dispatcher,dyn", [
    ("FELARE", "health_aware", OUTAGE), ("FELARE+", "health_aware", CHURN)],
    ids=["outage-health_aware", "churn-backup1"])
def test_network_under_faults_matches_jax_and_oracle(heuristic, dispatcher,
                                                     dyn, fused):
    """tiered_x4 under the dyadic tiered network and machine faults: a
    site outage with ``health_aware``, churn with ``with_backup(FELARE,
    1)``. Counters, makespans, task_log (ready times and retries) and the
    network series bit for bit with the JAX engine (energies within rel
    1e-6: tiered_x4 has 20 machines, ROADMAP C), event for event with
    ``pyengine``; orphans were made."""
    key = ("tiered", True)
    observers = ("task_log", "network")
    jout = _jax_run("tiered_x4", heuristic, dispatcher, key, dyn, observers)
    tout = _port_run("tiered_x4", heuristic, dispatcher, key, dyn,
                     observers, fused=fused)
    assert_runs_equal(jout, tout, heuristic, close=ENERGIES)
    assert int(tout[1]["task_log"]["retries"].sum()) > 0
    if not fused:
        jpol = (jfaults.with_backup("FELARE", 1) if heuristic.endswith("+")
                else heuristic)
        assert_matches_oracle(_traces("tiered_x4"), _fleet("tiered_x4"),
                              jpol, dispatcher, _net(*key)[0], tout[1],
                              heuristic, jdyn=_dynamics(dyn)[0])


def test_orphan_repays_its_link_and_a_failover_keeps_its_ready_time():
    """At the dispatch stage an orphan (PENDING, its site cleared by the
    faults stage) pays its link from its origin again: its ready time
    becomes ``now + lat`` and its link energy is charged once more. A
    task the faults stage failed over to a backup (QUEUED on the backup's
    site) keeps its ready time and pays nothing."""
    tiers = (0, 0, 0, 2)
    net = network.Tiered(**DYADIC["tiered"])
    B, N, S = 1, 3, 4
    trace = tengine.Trace(
        arrival=torch.zeros(B, N), task_type=torch.tensor([[1, 1, 2]]),
        deadline=torch.full((B, N), 100.0), exec_actual=torch.ones(B, N, 20))
    nt = tengine._make_net(net, tiers, S, trace)
    st = tengine._init_state(trace, 20, 2, S, 4, True, 1, 3)
    # task 0: an orphan; task 1: failed over to site 3 (the cloud);
    # task 2: queued where it landed long ago
    st = st._replace(
        now=torch.tensor([10.0]),
        status=torch.tensor([[PENDING, QUEUED, QUEUED]]),
        site=torch.tensor([[-1, 3, 1]]),
        ready=torch.tensor([[2.0, 2.0, 2.0]]),
        e_dyn=torch.tensor([5.0]), e_xfer=torch.tensor([[1.0, 0.0, 0.5]]))
    new = (st.status == PENDING) & (st.site < 0)
    got = tengine._pay_links(st._replace(site=torch.where(new, 3, st.site)),
                             trace, new, torch.full((B, N), 3), nt)
    lat = nt.lat[0, 0, 3]
    en = nt.en[0, 0, 3]
    assert float(lat) > 0 and float(en) > 0
    assert got.ready[0].tolist() == [10.0 + float(lat), 2.0, 2.0]
    assert float(got.e_dyn[0]) == 5.0 + float(en)
    assert got.e_xfer[0].tolist() == [1.0, 0.0, 0.5 + float(en)]
    assert got.status[0].tolist() == [PENDING, QUEUED, QUEUED]


def test_in_transit_tasks_past_their_deadline_are_cancelled():
    """A task still in transit at or past its deadline is cancelled at
    the dispatch stage and counted by type; its link energy stays
    spent."""
    net = network.UniformLatency(latency=4.0, energy=0.5)
    tiers = (0, 0)
    B, N, S = 1, 3, 4
    trace = tengine.Trace(
        arrival=torch.zeros(B, N), task_type=torch.tensor([[0, 2, 2]]),
        deadline=torch.tensor([[6.0, 3.0, 20.0]]),
        exec_actual=torch.ones(B, N, 8))
    nt = tengine._make_net(net, tiers, S, trace)
    st = tengine._init_state(trace, 8, 2, S, 2, n_tiers=1)._replace(
        now=torch.tensor([3.0]),
        status=torch.full((B, N), PENDING),
        site=torch.tensor([[1, 1, 1]]),
        ready=torch.tensor([[5.0, 5.0, 5.0]]))
    none = torch.zeros(B, N, dtype=torch.bool)
    got = tengine._pay_links(st, trace, none, st.site, nt)
    assert got.status[0].tolist() == [PENDING, CANCELLED, PENDING]
    assert got.cancelled[0].tolist() == [0, 0, 1, 0]
    assert float(got.e_dyn[0]) == 0.0


# ---------------------------------------------------------- the observer
def test_network_observer_without_network_matches_jax():
    """Without a network the series are well-formed zeros (T = 1, as the
    reference binds no tiers then), equal to the JAX observer's."""
    jout = _jax_run("paper_x2", "ELARE", "sticky", None,
                    observers=("network",))
    tout = _port_run("paper_x2", "ELARE", "sticky", None,
                     observers=("network",))
    assert_runs_equal(jout, tout, "no network")
    net = {k: v.numpy() for k, v in tout[1]["network"].items()}
    assert net["tier_load"].shape == (2, 64, 1)
    assert net["xfer_energy"].shape == (2, 64, 1)
    assert not net["xfer_energy"].any() and not net["in_transit"].any()
    assert net["tier_load"].max() > 0


def test_network_observer_series_are_consistent():
    """Under tiered on tiered_x4: T = 3 tiers, cumulative transfer energy
    never falls, its last bucket is the final state's transfer energy,
    and the tier loads stay within the machines' queues and runs."""
    spec = port_spec(_fleet("tiered_x4"))
    loop = tengine._make_loop(
        policy.get("FELARE"), spec.as_torch(CPU), queue_size=spec.queue_size,
        dispatcher="sticky", site_of_machine=spec.site_of_machine,
        observers=("network",), network=_net("tiered", True)[1],
        tier_of_site=spec.tier_of_site)
    st_, aux = loop(stack_traces(_traces("tiered_x4")))
    net = {k: v.numpy() for k, v in aux["network"].items()}
    K = 64
    assert net["tier_load"].shape == net["xfer_energy"].shape == (2, K, 3)
    assert net["in_transit"].shape == (2, K)
    assert np.all(np.diff(net["xfer_energy"], axis=1) >= 0)
    assert not net["tier_load"][:, :, 1].any()       # no edge-tier site
    assert not net["xfer_energy"][:, :, 1].any()
    assert net["tier_load"].max() <= 20 * 3
    np.testing.assert_array_equal(net["xfer_energy"][:, -1],
                                  st_.e_xfer.numpy())
    assert np.all(net["xfer_energy"][:, -1].sum(-1) > 0)


def test_network_observer_registered_and_round_trips():
    assert "network" in observe.list_observers()
    assert len(observe.list_observers()) == 6
    assert observe.describe("network") == jobs.describe("network")
    ob = observe.Network(n_buckets=16)
    d = json.loads(json.dumps(ob.to_json_dict()))
    assert d == jobs.Network(n_buckets=16).to_json_dict()
    assert observe.from_json_dict(d) == ob


# ------------------------------------------------------------------ safety
@given(seed=st.integers(0, 63), rate=st.sampled_from([2.0, 4.0, 8.0]),
       net=st.sampled_from(["uniform_latency", "tiered"]))
@settings(max_examples=4, deadline=None)
def test_no_task_starts_before_it_lands(seed, rate, net):
    """No task starts before its stamped ready time (in-transit tasks are
    hidden from the mapper), and every arrived task ends in a terminal
    status (a task that expires in transit is CANCELLED)."""
    spec = _fleet("tiered_x4")
    tr = jax_trace(seed, 50, rate, spec.eet)
    _, aux = tengine.simulate_batch(
        stack_traces([tr]), port_spec(spec), "FELARE", network=net,
        observers=("task_log",), dispatcher="fair_spill", device=CPU,
        use_fused_map=True)
    log = {k: v[0].numpy() for k, v in aux["task_log"].items()}
    started = log["start_time"] >= 0
    assert np.all(log["start_time"][started] >= log["ready_time"][started])
    final = log["status"]
    assert not np.any((final == PENDING) | (final == QUEUED)
                      | (final == RUNNING))


def test_network_reads_nothing_back():
    """No host sync in the network models, the observer, or the engine's
    network branches."""
    import repro_torch.core.network.base as base
    import repro_torch.core.network.builtins as builtins
    import repro_torch.core.observe.network as obs_net

    sources = [inspect.getsource(m) for m in (builtins, obs_net)]
    sources.append(inspect.getsource(base.hash_origins))
    sources += [inspect.getsource(f) for f in (
        tengine._make_net, tengine._stage_dispatch, tengine._pay_links,
        tengine._map_action, tengine._next_event_time)]
    sources.append(inspect.getsource(
        dispatch.builtins._task_site_minima))
    sources.append(inspect.getsource(dispatch.builtins.TierAware))
    for src in sources:
        for sync in (".item(", ".tolist(", "nonzero", ".cpu(", "bool(",
                     ".numpy("):
            assert sync not in src, sync


# ------------------------------------------------------------- CLI + spec
def test_cli_tiered_sweep_writes_artifacts(tmp_path, capsys):
    out = tmp_path / "tiered"
    tsweep.main(["--device", "cpu", "--system", "tiered_x4",
                 "--network", "tiered", "--dispatcher", "tier_aware",
                 "--observers", "network", "--rates", "4.0", "--reps", "1",
                 "--tasks", "40", "--heuristics", "FELARE", "--fused-map",
                 "--out", str(out)])
    payload = json.loads((out / "sweep.json").read_text())
    assert payload["spec"]["network"] == "tiered"
    assert (out / "sweep.csv").exists()
    obs = json.loads((out / "observers.json").read_text())
    assert len(obs["network"]["in_transit"][0][0][0]) == 64  # (H, R, K, 64)
    assert len(obs["network"]["xfer_energy"][0][0][0][0]) == 3
    assert "network=tiered" in capsys.readouterr().out


def test_cli_rejects_unknown_network(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--device", "cpu", "--network", "BOGUS"])
    assert e.value.code == 2
    assert "error: unknown network 'BOGUS'" in capsys.readouterr().err


def test_cli_list_networks(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--list-networks"])
    assert e.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    for name, line in zip(network.list_networks(), out):
        assert line.startswith(name)


def test_cli_list_fleets(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--list-fleets"])
    assert e.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + 11
    names = [line.split()[0] for line in out[1:]]
    assert names == scenarios.list_fleets()
    row = {line.split()[0]: line.split() for line in out[1:]}
    assert row["tiered_x4"][1:] == ["4", "20", "4", "0,0,0,2"]
    assert row["paper"][-1] == "flat"


def test_spec_network_validated_and_round_trips():
    with pytest.raises(ValueError, match="unknown network"):
        texp.SweepSpec(network="nope")
    with pytest.raises(ValueError, match="NetworkModel"):
        texp.SweepSpec(network=42)
    spec = texp.SweepSpec(system="tiered_x4", rates=(4.0,), reps=1,
                          n_tasks=20, heuristics=("FELARE",),
                          network="TIERED", dispatcher="tier_aware")
    assert spec.network == "tiered"
    back = texp.SweepSpec.from_json_dict(
        json.loads(json.dumps(spec.to_json_dict())))
    assert back == spec
    inst = texp.SweepSpec(system="tiered_x4", rates=(4.0,), reps=1,
                          n_tasks=20, heuristics=("FELARE",),
                          network=network.UniformLatency(latency=0.5))
    d = json.loads(json.dumps(inst.to_json_dict()))
    assert d["network"] == jnet.to_json_dict(jnet.UniformLatency(
        latency=0.5))
    back = texp.SweepSpec.from_json_dict(d)
    assert back.resolve_network() == network.UniformLatency(latency=0.5)
    sysd = texp.SweepSpec(system=scenarios.get_fleet("tiered_x4").build(),
                          rates=(4.0,), reps=1, n_tasks=20,
                          heuristics=("FELARE",), network="tiered")
    back = texp.SweepSpec.from_json_dict(
        json.loads(json.dumps(sysd.to_json_dict())))
    assert back.system.tier_of_site == (0, 0, 0, 2)
    assert back.system.site_of_machine == sysd.system.site_of_machine


def test_spec_old_payload_loads_without_network():
    """A sweep.json spec written before the network (no "network" key)
    loads with free links, as the reference's does."""
    d = texp.SweepSpec(rates=(4.0,), reps=1, n_tasks=20,
                       heuristics=("ELARE",)).to_json_dict()
    del d["network"]
    spec = texp.SweepSpec.from_json_dict(d)
    assert spec.network == "none"
    assert isinstance(spec.resolve_network(), network.NoNetwork)
    jd = jexp.SweepSpec(rates=(4.0,), reps=1, n_tasks=20,
                        heuristics=("ELARE",)).to_json_dict()
    assert jd["network"] == spec.to_json_dict()["network"]


def test_run_study_accepts_network():
    res = api.run_study("FELARE", [4.0], scenarios.get_fleet(
        "tiered_x4").build(), n_traces=2, n_tasks=30,
        dispatcher="tier_aware", network="tiered", device=CPU)
    assert len(res) == 1
    assert int(np.asarray(res[0].metrics.arrived_by_type).sum()) == 60
