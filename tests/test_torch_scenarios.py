"""The port's workload scenarios and synthetic fleets against the JAX
package's.

Transforms are fed the reference's own draws: each test redoes the
reference component's key split with ``jax.random`` and hands the draws
to the port's transform, which must give the reference's arrays bit for
bit (the diurnal process within its stated bound: float32 ``sin`` and
``cos`` differ between numpy and XLA in the last place). Port-synthesized
traces are held to the reference's properties in distribution, with
numpy seeds, as ``tests/test_scenarios.py`` holds the reference.
Registries, ``describe()``, JSON and the pinned fleet tables are held
equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro import scenarios as jscenarios
from repro.core import eet as jeet
from repro.experiments import sweep as jsweep
from repro_torch import experiments as texp
from repro_torch import scenarios
from repro_torch.core import api, dispatch, workload
from repro_torch.core import eet as teet
from repro_torch.core.equations import cumsum32, exp32
from repro_torch.datapipe import synthetic
from repro_torch.experiments import sweep as tsweep
from test_torch_common import CPU, SPEC

f32 = np.float32
EET = np.asarray(SPEC.eet)
CVB_EET = np.array(jscenarios.get_fleet("cvb").build().eet)
#: DiurnalArrivals: max |port - reference| over the nominal horizon
#: n / rate. Measured at most 3.4e-7 (98 % of the arrivals exact).
DIURNAL_REL_BOUND = 1e-6


def rep_keys(seed: int, reps: int):
    """Per replicate of ``Scenario.stack``: its (arrivals, types,
    runtimes) keys."""
    return [jax.random.split(k, 3)
            for k in jax.random.split(jax.random.PRNGKey(seed), reps)]


def exp_draw(key, n):
    return np.asarray(jax.random.exponential(key, (n,)))


def mmpp_draw(key, n):
    k_exp, k_switch, k_init = jax.random.split(key, 3)
    return (exp_draw(k_exp, n),
            np.asarray(jax.random.uniform(k_switch, (n,))),
            np.asarray(jax.random.uniform(k_init, ())))


def port_of(arrivals):
    """The port's arrival process of the reference's kind and
    parameters."""
    return scenarios.component_from_json(
        "arrivals", jscenarios.component_to_json(arrivals))


# --------------------------------------------------------------------------
# The scan helper and the exponential
# --------------------------------------------------------------------------
SCAN_LENGTHS = sorted(set(range(1, 41)) | {
    n + d for n in (48, 64, 255, 256, 1000, 2000, 4096, 8192)
    for d in (-1, 0, 1) if n + d <= 8192})


def test_cumsum32_is_xla_cumsum_bit_for_bit():
    rng = np.random.default_rng(0)
    for n in SCAN_LENGTHS:
        x = rng.exponential(size=(2, n)).astype(f32)
        np.testing.assert_array_equal(cumsum32(x),
                                      np.asarray(jnp.cumsum(x, axis=-1)),
                                      err_msg=f"n={n}")
    # and unlike a left-to-right sum
    x = rng.exponential(size=2000).astype(f32)
    assert not np.array_equal(np.cumsum(x, dtype=f32), cumsum32(x))


def test_cumsum32_batched_under_jit():
    x = np.random.default_rng(1).exponential(size=(5, 6, 2000)).astype(f32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    np.testing.assert_array_equal(cumsum32(x), want)


def test_exp32_is_xla_exp_bit_for_bit():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0, 1.5, 200_000),
                        rng.uniform(-100, 100, 200_000)]).astype(f32)
    np.testing.assert_array_equal(exp32(x), np.asarray(jnp.exp(x)))


# --------------------------------------------------------------------------
# Transforms fed the reference's draws
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rate", [2.0, 3.3, 8.0])
@pytest.mark.parametrize("n", [7, 2000])
def test_arrival_transforms_bit_for_bit(n, rate):
    key = jax.random.PRNGKey(int(10 * rate) + n)
    r32 = jnp.float32(rate)
    for ref, draws in [
            (jscenarios.PoissonArrivals(), (exp_draw(key, n),)),
            (jscenarios.FlashCrowdArrivals(), (exp_draw(key, n),)),
            (jscenarios.FlashCrowdArrivals(0.1, 0.3, 2.5),
             (exp_draw(key, n),)),
            (jscenarios.MMPPArrivals(), mmpp_draw(key, n)),
            (jscenarios.MMPPArrivals(4.0, 0.9, 0.4), mmpp_draw(key, n))]:
        want = np.asarray(ref.sample(key, n, r32))
        got = port_of(ref).transform(draws, f32(rate))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=repr(ref))


@pytest.mark.parametrize("proc", [jscenarios.DiurnalArrivals(),
                                  jscenarios.DiurnalArrivals(0.5, 2.0)])
def test_diurnal_transform_within_its_bound(proc):
    for seed, n, rate in [(0, 2000, 2.0), (1, 2000, 8.0), (2, 500, 3.0)]:
        key = jax.random.PRNGKey(seed)
        want = np.asarray(proc.sample(key, n, jnp.float32(rate)))
        got = port_of(proc).transform((exp_draw(key, n),), f32(rate))
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= DIURNAL_REL_BOUND * n / rate, (seed, err)
        assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("name", ["poisson", "bursty", "flash-crowd",
                                  "diurnal"])
def test_stacked_arrivals_from_the_reference_draws(name):
    """``Scenario.stack``'s path: the draws of K replicates transformed at
    R float32 rates at once, against the reference's stack."""
    ref = jscenarios.get(name)
    rates, reps, n = (2.0, 3.0, 8.0), 3, 300
    want = np.asarray(ref.stack(jax.random.PRNGKey(4), rates, reps, n,
                                EET).arrival)
    draw = mmpp_draw if name == "bursty" else (
        lambda k, n: (exp_draw(k, n),))
    per_rep = [draw(k[0], n) for k in rep_keys(4, reps)]
    draws = tuple(np.stack(d) for d in zip(*per_rep))
    got = scenarios.get(name).arrivals.transform(
        draws, np.asarray(rates, f32)[:, None])
    assert got.shape == (3, reps, n)
    if name == "diurnal":
        horizon = n / np.asarray(rates)[:, None, None]
        assert np.all(np.abs(got - want) <= DIURNAL_REL_BOUND * horizon)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tightness", [0.75, 0.7, 1.3])
@pytest.mark.parametrize("eet", [EET, CVB_EET], ids=["paper", "cvb"])
def test_scaled_deadlines_bit_for_bit(tightness, eet):
    ref = jscenarios.ScaledDeadlines(tightness)
    r = np.random.default_rng(3)
    arr = np.sort(r.uniform(0, 500, 400)).astype(f32)
    ttype = r.integers(0, eet.shape[0], 400).astype(np.int32)
    want = np.asarray(ref.deadlines(jnp.asarray(arr), jnp.asarray(ttype),
                                    eet))
    got = scenarios.ScaledDeadlines(tightness).deadlines(
        torch.from_numpy(arr), torch.from_numpy(ttype),
        torch.from_numpy(eet))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gamma_cv_by_type_transform_bit_for_bit():
    cvs = (0.05, 0.5, 0.13, 0.31)
    key = jax.random.PRNGKey(2)
    ttype = np.random.default_rng(0).integers(0, 4, 500).astype(np.int32)
    want = np.asarray(jscenarios.GammaRuntimes(cv_by_type=cvs).sample(
        key, EET, ttype, 0.1))
    cv_k = jnp.asarray(cvs, jnp.float32)[ttype][:, None]
    draw = jax.random.gamma(key, jnp.broadcast_to(1.0 / cv_k**2,
                                                  (500, EET.shape[1])))
    got = scenarios.GammaRuntimes(cv_by_type=cvs).transform(
        np.asarray(draw), EET, ttype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [0.6, 0.25, 1.1])
def test_lognormal_transform_bit_for_bit(sigma):
    key = jax.random.PRNGKey(4)
    ttype = np.random.default_rng(1).integers(0, 8, 600).astype(np.int32)
    want = np.asarray(jscenarios.LognormalRuntimes(sigma).sample(
        key, CVB_EET, ttype, 0.1))
    z = np.asarray(jax.random.normal(key, (600, CVB_EET.shape[1])))
    got = scenarios.LognormalRuntimes(sigma).transform(z, CVB_EET, ttype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 2000])
def test_drift_mix_transform_bit_for_bit(n):
    ref = jscenarios.DriftMix(start=(0.4, 0.3, 0.2, 0.1),
                              end=(0.1, 0.2, 0.3, 0.4))
    port = scenarios.DriftMix(ref.start, ref.end)
    key = jax.random.PRNGKey(n)
    # the reference's probability grid, formed as DriftMix.sample forms it
    p0 = jnp.asarray(ref.start, jnp.float32)
    p1 = jnp.asarray(ref.end, jnp.float32)
    w = jnp.linspace(0.0, 1.0, n)[:, None]
    grid = (1.0 - w) * (p0 / p0.sum()) + w * (p1 / p1.sum())
    np.testing.assert_array_equal(port.probs(n), np.asarray(grid))
    gumbel = np.asarray(jax.random.gumbel(key, (n, 4)))
    np.testing.assert_array_equal(port.transform(gumbel),
                                  np.asarray(ref.sample(key, n, 4)))


def test_weighted_mix_transform_bit_for_bit():
    for probs in [(0.55, 0.25, 0.12, 0.08), (3.0, 0.0, 1.0, 1.0, 2.0)]:
        ref = jscenarios.WeightedMix(probs)
        key = jax.random.PRNGKey(len(probs))
        u = np.asarray(jax.random.uniform(key, (3000,)))
        np.testing.assert_array_equal(
            scenarios.WeightedMix(probs).transform(u),
            np.asarray(ref.sample(key, 3000, len(probs))))


def test_cvb_transform_bit_for_bit():
    for S, M, cvt, cvm in [(8, 6, 0.6, 0.6), (4, 3, 0.6, 0.9),
                           (5, 7, 0.3, 0.2)]:
        key = jax.random.PRNGKey(S * M)
        k_task, k_mach = jax.random.split(key)
        g_task = jax.random.gamma(k_task, 1.0 / cvt**2, (S,))
        g_mach = jax.random.gamma(k_mach, 1.0 / cvm**2, (S, M))
        want = np.asarray(jeet.cvb_eet(key, S, M, mean_task=3.0,
                                       cv_task=cvt, cv_mach=cvm))
        got = teet.cvb_from_draws(np.asarray(g_task), np.asarray(g_mach),
                                  3.0, cvt, cvm)
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# Distribution properties under numpy seeds
# --------------------------------------------------------------------------
ALL_ARRIVALS = [scenarios.PoissonArrivals(), scenarios.MMPPArrivals(),
                scenarios.DiurnalArrivals(), scenarios.FlashCrowdArrivals()]


def _gaps_cv2(arrivals: np.ndarray) -> float:
    g = np.diff(arrivals)
    return float(g.var() / g.mean() ** 2)


@pytest.mark.parametrize("seed,rate", [(0, 0.5), (1, 3.0), (2, 11.5)])
def test_arrivals_sorted_nonnegative_finite(seed, rate):
    for proc in ALL_ARRIVALS:
        a = proc.sample(np.random.default_rng(seed), 512, rate)
        assert a.shape == (512,) and a.dtype == np.float32, proc.kind
        assert np.all(np.isfinite(a)) and np.all(a >= 0), proc.kind
        assert np.all(np.diff(a) >= 0), proc.kind


@pytest.mark.parametrize("seed,rate", [(3, 1.0), (4, 4.5), (5, 10.0)])
def test_empirical_rate_matches_nominal(seed, rate):
    n = 4000
    for proc, cv2_bound in [(scenarios.PoissonArrivals(), 1.0),
                            (scenarios.MMPPArrivals(), 12.0),
                            (scenarios.DiurnalArrivals(), 2.0)]:
        t_n = float(proc.sample(np.random.default_rng(seed), n, rate)[-1])
        tol = 8.0 * rate * np.sqrt(cv2_bound / n)
        assert abs(n / t_n - rate) < tol, (proc.kind, n / t_n, rate)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mmpp_burstier_than_poisson(seed):
    cv2_poisson = _gaps_cv2(scenarios.PoissonArrivals().sample(
        np.random.default_rng(seed), 4000, 3.0))
    cv2_mmpp = _gaps_cv2(scenarios.MMPPArrivals().sample(
        np.random.default_rng(seed), 4000, 3.0))
    assert cv2_mmpp > cv2_poisson + 0.1
    assert cv2_mmpp > 1.15      # about 1.6 for the default parameters
    assert 0.6 < cv2_poisson < 1.5


def test_mmpp_chain_is_vectorized_over_replicates():
    """The phase chain over (K, N) draws equals K single-trace chains."""
    proc = scenarios.MMPPArrivals()
    draws = [proc.draw(np.random.default_rng(s), 300) for s in range(4)]
    stacked = proc.burst_phase(np.stack([d[1] for d in draws]),
                               np.stack([d[2] for d in draws]))
    for k, d in enumerate(draws):
        np.testing.assert_array_equal(stacked[k], proc.burst_phase(d[1], d[2]))
    assert 0.15 < stacked.mean() < 0.45     # burst_frac 0.3


@pytest.mark.parametrize("name", jscenarios.list_scenarios())
def test_crn_invariance_across_rates(name):
    scn = scenarios.get(name)
    eet = (scn.fleet.build() if scn.fleet is not None
           else scenarios.get_fleet("paper").build()).eet
    st = scn.stack(9, (1.5, 6.0), 2, 64, eet, device=CPU)
    assert torch.equal(st.task_type[0], st.task_type[1])
    assert torch.equal(st.exec_actual[0], st.exec_actual[1])
    assert torch.all(st.arrival[0] >= st.arrival[1])


def test_poisson_crn_arrivals_scale_inversely():
    st = scenarios.get("poisson").stack(3, (1.0, 4.0), 4, 60, EET,
                                        device=CPU)
    np.testing.assert_allclose(st.arrival[0].numpy(),
                               4.0 * st.arrival[1].numpy(), rtol=1e-5)


def test_flash_crowd_concentrates_mass_in_window():
    n, rate = 4000, 3.0
    a = scenarios.FlashCrowdArrivals(0.4, 0.15, 6.0).sample(
        np.random.default_rng(0), n, rate)
    horizon = n / rate
    t0, t1 = 0.4 * horizon, 0.55 * horizon
    assert np.sum((a >= t0) & (a <= t1)) > 3.0 * rate * (t1 - t0)


def test_diurnal_rate_oscillates():
    n, rate = 8000, 3.0
    a = scenarios.DiurnalArrivals(0.8, 4.0).sample(np.random.default_rng(1),
                                                   n, rate)
    counts, _ = np.histogram(a, bins=np.linspace(0.0, n / rate, 33))
    assert counts.max() > 1.3 * n / 32 and counts.min() < 0.7 * n / 32


def test_weighted_mix_respects_probs_and_validates():
    t = scenarios.WeightedMix((0.7, 0.1, 0.1, 0.1)).sample(
        np.random.default_rng(0), 4000, 4)
    assert abs(np.mean(t == 0) - 0.7) < 0.05
    assert t.dtype == np.int64 and t.min() >= 0 and t.max() < 4
    with pytest.raises(ValueError):
        scenarios.WeightedMix((0.5, 0.5)).sample(np.random.default_rng(0),
                                                 10, 4)
    for bad in [(), (-1.0, 2.0)]:
        with pytest.raises(ValueError):
            scenarios.WeightedMix(bad)


def test_drift_mix_drifts():
    t = scenarios.DriftMix(start=(0.9, 0.1, 0.0, 0.0),
                           end=(0.0, 0.0, 0.1, 0.9)).sample(
        np.random.default_rng(0), 4000, 4)
    assert np.mean(t[:1000] == 0) > 0.5 and np.mean(t[-1000:] == 3) > 0.5
    with pytest.raises(ValueError):
        scenarios.DriftMix(start=(0.5, 0.5), end=(1.0,))


def test_scaled_deadlines_interpolate_paper():
    tr = scenarios.get("poisson").sample_trace(0, 64, 3.0, EET, device=CPU)
    args = (tr.arrival, tr.task_type, torch.from_numpy(EET))
    paper = scenarios.PaperDeadlines().deadlines(*args)
    assert torch.all(scenarios.ScaledDeadlines(0.75).deadlines(*args) < paper)
    assert torch.all(scenarios.ScaledDeadlines(1.5).deadlines(*args) > paper)
    # arr + (e_bar_i + e_bar) against (arr + e_bar_i) + e_bar
    np.testing.assert_allclose(
        scenarios.ScaledDeadlines(1.0).deadlines(*args).numpy(),
        paper.numpy(), rtol=1e-6)
    assert torch.all(scenarios.ScaledDeadlines(0.75).deadlines(*args)
                     > tr.arrival)


def test_gamma_runtimes_per_type_cv():
    n = 6000
    ttype = np.asarray([0, 1] * (n // 2))
    draws = scenarios.GammaRuntimes(cv_by_type=(0.05, 0.5, 0.1, 0.1)).sample(
        np.random.default_rng(2), EET, ttype, 0.1)
    for s, cv in [(0, 0.05), (1, 0.5)]:
        rel = draws[ttype == s, 0] / float(EET[s, 0])
        assert abs(rel.mean() - 1.0) < 0.05
        assert abs(rel.std() - cv) < 0.25 * cv + 0.01
    with pytest.raises(ValueError):
        scenarios.GammaRuntimes(cv_by_type=(0.1, 0.1)).sample(
            np.random.default_rng(0), EET, ttype, 0.1)


def test_lognormal_runtimes_mean_preserving_heavy_tail():
    n = 8000
    ttype = np.zeros(n, np.int64)
    ln = scenarios.LognormalRuntimes(0.6).sample(np.random.default_rng(4),
                                                 EET, ttype, 0.1)
    gm = scenarios.GammaRuntimes().sample(np.random.default_rng(4), EET,
                                          ttype, 0.1)
    rel_ln, rel_gm = ln[:, 0] / EET[0, 0], gm[:, 0] / EET[0, 0]
    assert abs(rel_ln.mean() - 1.0) < 0.05
    assert np.quantile(rel_ln, 0.999) > np.quantile(rel_gm, 0.999) * 1.5


def test_type_probs_keyword_swaps_in_a_weighted_mix():
    probs = (0.55, 0.25, 0.12, 0.08)
    want = scenarios.replace(scenarios.DEFAULT,
                             mix=scenarios.WeightedMix(probs)).stack(
        5, (2.0, 4.0), 2, 300, EET, device=CPU)
    got = synthetic.trace_stack(5, (2.0, 4.0), 2, 300, EET,
                                type_probs=probs, device=CPU)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    one = workload.poisson_trace(6, 3000, 3.0, EET, type_probs=probs,
                                 device=CPU)
    freq = np.bincount(one.task_type.numpy(), minlength=4) / 3000
    np.testing.assert_allclose(freq, probs, atol=0.03)


# --------------------------------------------------------------------------
# Registries and description
# --------------------------------------------------------------------------
def test_registries_equal_the_references():
    assert scenarios.list_scenarios() == jscenarios.list_scenarios()
    assert scenarios.list_fleets() == jscenarios.list_fleets()
    assert sorted(scenarios.__all__) == sorted(jscenarios.__all__)
    for name in jscenarios.list_scenarios():
        assert scenarios.get(name).describe() == \
            jscenarios.get(name).describe(), name
        assert scenarios.get(name).to_json_dict() == \
            jscenarios.get(name).to_json_dict(), name
    for name in jscenarios.list_fleets():
        assert scenarios.component_to_json(scenarios.get_fleet(name)) == \
            jscenarios.component_to_json(jscenarios.get_fleet(name)), name
    assert scenarios.default_scenario() is scenarios.get("POISSON")


def test_scenario_registry_roundtrip():
    scn = scenarios.Scenario(scenarios.PoissonArrivals(),
                             scenarios.UniformMix(),
                             scenarios.ScaledDeadlines(0.5),
                             scenarios.GammaRuntimes())
    scenarios.register("test-tight", scn)
    try:
        assert scenarios.is_registered("TEST-TIGHT")
        assert scenarios.get("test-tight") is scn
        with pytest.raises(ValueError):
            scenarios.register("test-tight", scn)
        scenarios.register("test-tight", scn, overwrite=True)
        assert texp.SweepSpec(scenario="test-tight").resolve_scenario() \
            is scn
    finally:
        scenarios.unregister("test-tight")
    assert not scenarios.is_registered("test-tight")
    with pytest.raises(KeyError):
        scenarios.get("test-tight")
    with pytest.raises(TypeError):
        scenarios.register("not-a-scenario", object())


def test_fleet_registry_roundtrip():
    fleet = scenarios.RangeFleet(n_task_types=2, n_machines=2, seed=9)
    scenarios.register_fleet("tiny-test-fleet", fleet)
    try:
        assert scenarios.is_registered_fleet("TINY-TEST-FLEET")
        assert scenarios.get_fleet("tiny-test-fleet") is fleet
        with pytest.raises(ValueError):
            scenarios.register_fleet("tiny-test-fleet", fleet)
    finally:
        scenarios.unregister_fleet("tiny-test-fleet")
    assert not scenarios.is_registered_fleet("tiny-test-fleet")
    with pytest.raises(KeyError):
        scenarios.get_fleet("tiny-test-fleet")
    with pytest.raises(TypeError):
        scenarios.register_fleet("no-build", object())


def test_component_parameter_validation():
    for make in [lambda: scenarios.MMPPArrivals(rate_ratio=0.5),
                 lambda: scenarios.MMPPArrivals(burst_frac=1.5),
                 lambda: scenarios.MMPPArrivals(p_stay=0.5, burst_frac=0.9),
                 lambda: scenarios.DiurnalArrivals(amplitude=1.2),
                 lambda: scenarios.FlashCrowdArrivals(spike_mult=0.5),
                 lambda: scenarios.ScaledDeadlines(0.0),
                 lambda: scenarios.LognormalRuntimes(sigma=-1.0),
                 lambda: scenarios.GammaRuntimes(cv_by_type=(0.1, -1.0)),
                 lambda: scenarios.RangeFleet(eet_range=(5.0, 0.5)),
                 lambda: scenarios.MixedSitesFleet(site_machines=(2,),
                                                   cv_mach=(0.3, 0.4))]:
        with pytest.raises(ValueError):
            make()


# --------------------------------------------------------------------------
# JSON
# --------------------------------------------------------------------------
CUSTOM = scenarios.Scenario(
    scenarios.MMPPArrivals(rate_ratio=4.0, p_stay=0.9),
    scenarios.DriftMix(start=(0.7, 0.3), end=(0.2, 0.8)),
    scenarios.ScaledDeadlines(0.8),
    scenarios.GammaRuntimes(cv_by_type=(0.05, 0.4)),
    fleet=scenarios.RangeFleet(n_task_types=2, n_machines=3, seed=1))


@pytest.mark.parametrize("name", jscenarios.list_scenarios() + ["custom"])
def test_scenario_json_round_trips_both_ways(name):
    scn = CUSTOM if name == "custom" else scenarios.get(name)
    d = json.loads(json.dumps(scn.to_json_dict()))
    assert scenarios.Scenario.from_json_dict(d) == scn
    ref = jscenarios.Scenario.from_json_dict(d)
    if name != "custom":
        assert ref == jscenarios.get(name)
    back = json.loads(json.dumps(ref.to_json_dict()))
    assert back == d
    assert scenarios.Scenario.from_json_dict(back) == scn


def test_scenario_hashable_replace_and_unknown_kind():
    scn = scenarios.get("bursty")
    assert hash(scn) == hash(scenarios.get("bursty"))
    tweaked = scenarios.replace(
        scn, arrivals=dataclasses.replace(scn.arrivals, rate_ratio=16.0))
    assert tweaked != scn and tweaked.arrivals.rate_ratio == 16.0
    with pytest.raises(ValueError, match="unknown arrivals"):
        scenarios.component_from_json("arrivals", {"kind": "nope"})


def test_sweep_spec_with_embedded_scenario_and_dispatcher_round_trips():
    spec = texp.SweepSpec(system="paper_x2",
                          scenario=scenarios.get("federated-skew"),
                          dispatcher=dispatch.Sticky(by_type=True),
                          rates=(4.0,), reps=1, n_tasks=20,
                          heuristics=("FELARE",))
    d = json.loads(json.dumps(spec.to_json_dict()))
    assert d["scenario"] == jscenarios.get("federated-skew").to_json_dict()
    assert texp.SweepSpec.from_json_dict(d) == spec
    # the reference reads the port's scenario block
    assert jexp.SweepSpec(scenario=jscenarios.Scenario.from_json_dict(
        d["scenario"])).resolve_scenario() == jscenarios.get(
        "federated-skew")
    named = texp.SweepSpec(scenario="drift", reps=1, n_tasks=20)
    assert texp.SweepSpec.from_json_dict(
        json.loads(json.dumps(named.to_json_dict()))) == named
    with pytest.raises(ValueError, match="unknown scenario"):
        texp.SweepSpec(scenario="nope")
    with pytest.raises(ValueError, match="Scenario"):
        texp.SweepSpec(scenario=42)


def test_spec_system_defaults_to_the_scenarios_fleet():
    for name in jscenarios.list_scenarios():
        got = texp.SweepSpec(scenario=name).resolve_system()
        want = jexp.SweepSpec(scenario=name).resolve_system()
        np.testing.assert_array_equal(got.eet, np.asarray(want.eet))
        assert got.site_of_machine == want.site_of_machine, name
    assert texp.SweepSpec(scenario="wide-fleet",
                          system="paper").resolve_system().eet.shape == (4, 4)


# --------------------------------------------------------------------------
# Fleet tables
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cvb", "range", "mixed_sites",
                                  "wide-fleet"])
def test_registered_fleets_equal_the_references_bit_for_bit(name):
    if name == "wide-fleet":
        got = scenarios.get(name).fleet.build()
        ref = jscenarios.get(name).fleet.build()
    else:
        got = scenarios.get_fleet(name).build()
        ref = jscenarios.get_fleet(name).build()
    for field in ("eet", "p_dyn", "p_idle"):
        a, b = getattr(got, field), np.asarray(getattr(ref, field))
        assert a.dtype == np.float32
        assert a.tobytes() == b.tobytes(), field
    for field in ("queue_size", "fairness_factor", "site_of_machine",
                  "tier_of_site", "n_sites"):
        assert getattr(got, field) == getattr(ref, field), field


def test_other_fleet_parameters_draw_from_the_seed():
    f = scenarios.CvbFleet(n_task_types=5, n_machines=7, seed=3)
    s1, s2 = f.build(), f.build()
    assert s1.eet.shape == (5, 7) and s1.eet.dtype == np.float32
    np.testing.assert_array_equal(s1.eet, s2.eet)
    assert not np.array_equal(s1.eet, scenarios.CvbFleet(
        n_task_types=5, n_machines=7, seed=4).build().eet)
    assert not np.array_equal(scenarios.CvbFleet(seed=1).build().eet,
                              scenarios.get_fleet("cvb").build().eet)
    r = scenarios.RangeFleet(n_task_types=3, n_machines=4, seed=0,
                             eet_range=(0.5, 5.0)).build()
    assert r.eet.shape == (3, 4)
    assert np.all(r.eet >= 0.5) and np.all(r.eet <= 5.0)
    assert np.all(r.p_dyn >= 1.0) and np.all(r.p_dyn <= 3.0)
    m = scenarios.MixedSitesFleet(site_machines=(2, 3, 1),
                                  cv_mach=(0.3, 0.6, 0.9), seed=5).build()
    assert m.eet.shape == (4, 6)
    assert m.site_of_machine == (0, 0, 1, 1, 1, 2)


def test_cvb_eet_moments():
    """CVB rows: the type baselines have mean ``mean_task`` and CV
    ``cv_task`` (pooled over many draws)."""
    eet = teet.cvb_eet(np.random.default_rng(0), 4000, 2, mean_task=3.0,
                       cv_task=0.6, cv_mach=0.05)
    base = eet.mean(1)
    assert abs(base.mean() - 3.0) < 0.1
    assert abs(base.std() / base.mean() - 0.6) < 0.05


# --------------------------------------------------------------------------
# The CLI and run_study
# --------------------------------------------------------------------------
def test_cli_list_scenarios_prints_the_references_table(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--list-scenarios"])
    assert e.value.code == 0
    got = capsys.readouterr().out
    want = io.StringIO()
    jsweep.print_scenario_list(file=want)
    assert got == want.getvalue()


def test_cli_unknown_scenario_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.build_spec(["--device", "cpu", "--scenario", "nope"])
    assert e.value.code == 2
    assert "error: unknown scenario 'nope'" in capsys.readouterr().err


def test_cli_scenario_and_mixed_sites_runs(tmp_path, capsys):
    res = tsweep.main(["--device", "cpu", "--scenario", "bursty", "--rates",
                       "4", "--reps", "2", "--tasks", "60", "--heuristics",
                       "ELARE,FELARE", "--out", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "system=paper scenario=bursty" in out
    assert res.spec.scenario == "bursty"
    assert res.run_info["FELARE"]["scenario"] == "bursty"
    saved = json.loads((tmp_path / "a" / "sweep.json").read_text())
    assert saved["spec"]["scenario"] == "bursty"
    res = tsweep.main(["--device", "cpu", "--system", "mixed_sites",
                       "--dispatcher", "least_queued", "--rates", "4",
                       "--reps", "2", "--tasks", "60", "--heuristics",
                       "FELARE", "--out", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "sites=2 dispatcher=least_queued" in out
    assert res.metrics.arrived_by_type.sum() == 2 * 60
    res = tsweep.main(["--device", "cpu", "--scenario", "wide-fleet",
                       "--rates", "4", "--reps", "1", "--tasks", "40",
                       "--heuristics", "FELARE", "--out",
                       str(tmp_path / "c")])
    assert "system=scenario fleet scenario=wide-fleet" in \
        capsys.readouterr().out
    assert res.metrics.arrived_by_type.shape[-1] == 8


def test_run_study_takes_scenario_observers_and_dynamics():
    spec = scenarios.get_fleet("paper_x2").build()
    cells = api.run_study("FELARE", (4.0, 8.0), spec, n_traces=2,
                          n_tasks=50, scenario="federated-skew",
                          observers=("task_log",), dynamics="site_outage",
                          dispatcher="health_aware", device=CPU)
    assert [c.arrival_rate for c in cells] == [4.0, 8.0]
    for c in cells:
        assert c.aux["task_log"]["site"].shape == (2, 50)
        assert np.asarray(c.metrics.arrived_by_type).sum() == 2 * 50
    plain = api.run_study("FELARE", (4.0,), spec, n_traces=2, n_tasks=50,
                          device=CPU)
    assert plain[0].aux is None
