"""The port's serving router (``repro_torch.cluster``) against the JAX
package's, on the CPU.

``tests/test_router.py``'s cases, ported; the roofline profiles equal
for all ten architectures; and overloaded request streams (the paper's
2 x 2 miniature and Table I's 4 x 4) driven through both Routers, whose
``metrics()`` must be equal bit for bit, every field (the EET EMA, the
Python-float energies and Jain's index included), with the port's policy
plain and through its fused wrappers (their plain versions on CPU
tensors).
"""
import functools
import heapq

import numpy as np
import pytest
import torch

from repro.cluster import profiles as jprof
from repro.cluster.router import Request as JRequest
from repro.cluster.router import Router as JRouter
from repro.configs import registry as jreg
from repro.core import api as japi
from repro_torch.cluster import profiles as tprof
from repro_torch.cluster.router import Request, Router
from repro_torch.configs import registry
from repro_torch.core import policy as tpolicy

torch.set_num_threads(1)

EET_2X2 = np.array([[1.0, 0.3], [2.0, 0.6]], np.float32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _router(heuristic="FELARE", eet=None, **kw):
    clock = FakeClock()
    if eet is None:
        eet = EET_2X2
    r = Router(eet, p_dyn=np.array([1.0, 5.0]), p_idle=np.array([0.1, 0.5]),
               heuristic=heuristic, now_fn=clock, device="cpu", **kw)
    return r, clock


# --------------------------------------------------------------------------
# tests/test_router.py, ported
# --------------------------------------------------------------------------
class TestRouterLifecycle:
    def test_request_maps_and_starts(self):
        r, clock = _router()
        started = r.on_request(Request(0, 0, 0.0, deadline=10.0))
        assert len(started) == 1
        j, req = started[0]
        assert req.status == "running"
        assert j == 0  # ELARE-family picks the min-energy feasible machine

    def test_completion_updates_metrics_and_eet(self):
        r, clock = _router()
        (j, req), = r.on_request(Request(0, 0, 0.0, deadline=10.0))
        clock.t = 0.9
        r.on_completion(j, success=True, latency=0.9)
        m = r.metrics()
        assert m["completed"][0] == 1
        assert m["eet"][0, j] != pytest.approx(1.0)  # EMA moved

    def test_straggler_adaptation_shifts_routing(self):
        """A machine that keeps running slow loses traffic (EET EMA)."""
        r, clock = _router(heuristic="ELARE", eet=np.array(
            [[0.5, 0.6]], np.float32))
        for k in range(8):
            started = r.on_request(
                Request(k, 0, clock.t, deadline=clock.t + 3.0))
            for j, req in started:
                clock.t += 5.0 if j == 0 else 0.6
                r.on_completion(j, success=(j != 0),
                                latency=5.0 if j == 0 else 0.6)
        assert r.eet[0, 0] > r.eet[0, 1]  # learned machine 0 is slow

    def test_deadline_miss_counts_missed(self):
        r, clock = _router()
        (j, req), = r.on_request(Request(0, 0, 0.0, deadline=0.5))
        clock.t = 2.0
        r.on_completion(j, success=False, latency=2.0)
        m = r.metrics()
        assert m["missed"][0] == 1
        assert m["energy_wasted"] > 0

    def test_fairness_tracking(self):
        r, clock = _router()
        for k in range(6):
            started = r.on_request(
                Request(k, k % 2, clock.t, deadline=clock.t + 8.0))
            for j, req in started:
                clock.t += 0.3
                r.on_completion(j, success=(req.task_type == 0),
                                latency=0.3)
        m = r.metrics()
        assert m["completion_rate_by_type"][0] > \
            m["completion_rate_by_type"][1]
        assert 0 < m["jain_fairness"] <= 1.0


class TestRooflineEET:
    def test_eet_from_roofline_ordering(self):
        """Bigger archs cost more everywhere; faster machines are faster."""
        cfgs = [registry.get_config("qwen1.5-0.5b"),
                registry.get_config("internlm2-1.8b")]
        eet = tprof.eet_from_roofline(cfgs)
        assert eet.shape == (2, len(tprof.FLEET))
        assert (eet[1] > eet[0]).all()          # 1.8b slower than 0.5b
        names = [m.name for m in tprof.FLEET]
        fast, slow = names.index("v5e-4"), names.index("cpu-host")
        assert (eet[:, fast] < eet[:, slow]).all()

    def test_request_cost_scales(self):
        cfg = registry.get_config("qwen1.5-0.5b")
        f1, _ = tprof.request_cost(cfg, 128)
        f2, _ = tprof.request_cost(cfg, 256)
        assert f2 == pytest.approx(2 * f1)

    def test_power_vectors(self):
        p_dyn, p_idle = tprof.power_vectors()
        assert (p_dyn > p_idle).all()


class TestRouterHeuristics:
    @pytest.mark.parametrize("h", ["FELARE", "ELARE", "MM", "MSD", "MMU"])
    def test_all_heuristics_drive_router(self, h):
        r, clock = _router(heuristic=h)
        for k in range(10):
            clock.t += 0.2
            started = r.on_request(
                Request(k, k % 2, clock.t, deadline=clock.t + 4.0))
            for j, req in started:
                clock.t += float(r.eet[req.task_type, j])
                r.on_completion(j, success=True,
                                latency=float(r.eet[req.task_type, j]))
        m = r.metrics()
        total = (m["completed"] + m["missed"] + m["cancelled"]).sum()
        assert m["arrived"].sum() - total >= 0  # conservation
        assert m["completed"].sum() > 0


def test_router_wants_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Router(EET_2X2, np.ones(2), np.ones(2))


# --------------------------------------------------------------------------
# profiles against the reference
# --------------------------------------------------------------------------
def test_fleet_matches_the_reference():
    assert [vars(m) for m in tprof.FLEET] == [vars(m) for m in jprof.FLEET]
    for got, want in zip(tprof.power_vectors(), jprof.power_vectors()):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_profiles_match_the_reference(arch, decode):
    tcfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    for n in (1, 256, 4096):
        assert tprof.request_cost(tcfg, n, decode=decode) == \
            jprof.request_cost(jcfg, n, decode=decode)
    got = tprof.eet_from_roofline([tcfg], n_tokens=512, decode=decode)
    want = jprof.eet_from_roofline([jcfg], n_tokens=512, decode=decode)
    np.testing.assert_array_equal(got, want)


def test_eet_over_all_ten_archs_matches_the_reference():
    got = tprof.eet_from_roofline(list(registry.all_configs().values()))
    want = jprof.eet_from_roofline(list(jreg.all_configs().values()))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# overloaded request streams through both Routers
# --------------------------------------------------------------------------
STREAMS = {  # eet, p_dyn, p_idle, requests, arrival rate
    "2x2": (EET_2X2, np.array([1.0, 5.0]), np.array([0.1, 0.5]), 24, 6.0),
    "4x4": (np.asarray(japi.paper_system().eet, np.float32),
            np.asarray(japi.paper_system().p_dyn),
            np.asarray(japi.paper_system().p_idle), 24, 4.0),
}
FUSED = {"map": tpolicy.with_fused_map, "phase1": tpolicy.with_fused_phase1}


def drive(router_cls, request_cls, stream, heuristic, **kw) -> dict:
    """Serve a seeded stream: Poisson arrivals past the fleet's capacity,
    Eq. 4-style slack, executed latencies 0.8-1.6 x the EET."""
    eet, p_dyn, p_idle, n, rate = STREAMS[stream]
    clock = FakeClock()
    r = router_cls(eet, p_dyn, p_idle, heuristic=heuristic, now_fn=clock,
                   **kw)
    rng = np.random.default_rng(1)
    slack = eet.mean(1) + eet.mean()
    events, t = [], 0.0
    for rid in range(n):
        t += rng.exponential(1.0 / rate)
        heapq.heappush(events, (t, 0, rid, int(rng.integers(0, len(eet)))))
    while events:
        tm, kind, a, b = heapq.heappop(events)
        clock.t = tm
        if kind == 0:
            started = r.on_request(request_cls(a, b, tm,
                                               tm + float(slack[b])))
        else:
            req = r.running[a]
            started = r.on_completion(a, success=tm <= req.deadline,
                                      latency=tm - req.start)
        for j, req in started:
            real = float(eet[req.task_type, j]) * rng.uniform(0.8, 1.6)
            heapq.heappush(events, (tm + real, 1, j, 0))
    return r.metrics()


@functools.lru_cache(maxsize=None)
def reference(stream, heuristic):
    return drive(JRouter, JRequest, stream, heuristic)


@pytest.fixture
def fused_names():
    """Register the fused variants under names for the run; remove them
    after."""
    names = {}
    for heuristic in ("FELARE", "ELARE", "MM"):
        for kind, wrap in FUSED.items():
            name = f"{heuristic}_FUSED_{kind.upper()}_TEST"
            tpolicy.register(name, wrap(heuristic), overwrite=True)
            names[heuristic, kind] = name
    yield names
    for name in names.values():
        tpolicy.unregister(name)


@pytest.mark.parametrize("path", ["plain", "map", "phase1"])
@pytest.mark.parametrize("heuristic", ["FELARE", "ELARE", "MM"])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_stream_metrics_match_the_reference(stream, heuristic, path,
                                            fused_names):
    want = reference(stream, heuristic)
    # the streams are overloaded: requests are lost
    assert (want["missed"] + want["cancelled"]).sum() > 0
    name = heuristic if path == "plain" else fused_names[heuristic, path]
    got = drive(Router, Request, stream, name, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert type(got[k]) is type(v), k
            assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k


def test_router_counts_its_policy_calls():
    r, clock = _router()
    r.on_request(Request(0, 0, 0.0, deadline=10.0))
    assert r.map_calls == 1 and r.map_seconds > 0
    clock.t = 0.5
    r.on_completion(0, success=True, latency=0.5)   # nothing left to map
    assert r.map_calls == 1
