"""The port's Eqs. 1-4, Eq. 3 fairness limit and suffered-type mask against
``repro.core.equations`` / ``repro.core.fairness``, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import equations as jeq
from repro.core import fairness as jfair
from repro_torch.core import equations as teq
from repro_torch.core import fairness as tfair
from test_torch_common import SPEC, to_np

torch.set_num_threads(1)


def _grid(seed, n=4000):
    """(start, exec, deadline, p_dyn) draws that hit all three Eq. 1/2
    regimes, with exact boundary cases s + e == d and s == d."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    s = r.uniform(0, 20, n).astype(f32)
    e = r.uniform(0.1, 8, n).astype(f32)
    d = (s + r.uniform(-6, 10, n)).astype(f32)
    d[:50] = s[:50] + e[:50]
    d[50:100] = s[50:100]
    p = r.uniform(1, 5, n).astype(f32)
    return s, e, d, p


@pytest.mark.parametrize("seed", [0, 1])
def test_completion_time_and_feasible(seed):
    s, e, d, _ = _grid(seed)
    ref = np.asarray(jeq.completion_time(s, e, d))
    got = to_np(teq.completion_time(*map(torch.from_numpy, (s, e, d))))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        to_np(teq.feasible(*map(torch.from_numpy, (s, e, d)))),
        np.asarray(jeq.feasible(s, e, d)))


@pytest.mark.parametrize("seed", [0, 1])
def test_expected_energy(seed):
    s, e, d, p = _grid(seed)
    ref = np.asarray(jeq.expected_energy(s, e, d, p))
    got = to_np(teq.expected_energy(*map(torch.from_numpy, (s, e, d, p))))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("eet", [SPEC.eet, np.float32([[0.57, 0.27],
                                                       [3.38, 0.98]])],
                         ids=["paper", "aws"])
def test_deadlines_eq4(eet):
    r = np.random.default_rng(3)
    S = eet.shape[0]
    arrival = np.cumsum(r.exponential(0.3, 500)).astype(np.float32)
    ttype = r.integers(0, S, 500)
    ref = np.asarray(jeq.deadlines(arrival, ttype.astype(np.int32), eet))
    got = teq.deadlines(torch.from_numpy(arrival), torch.from_numpy(ttype),
                        torch.from_numpy(eet))
    np.testing.assert_array_equal(to_np(got), ref)


def test_urgency():
    s, e, d, _ = _grid(4)
    now = np.float32(3.5)
    d[:20] = now + e[:20]                      # zero slack -> 1e-9 guard
    ref = np.asarray(jeq.urgency(d, e, now))
    got = teq.urgency(torch.from_numpy(d), torch.from_numpy(e),
                      torch.tensor(now))
    np.testing.assert_array_equal(to_np(got), ref)


def _rates(seed, n=400, S=4):
    r = np.random.default_rng(seed)
    cr = r.random((n, S)).astype(np.float32)
    cr[:40] = np.float32(1 / 3)                # all equal: sigma = 0
    cr[40:80] = r.random((40, 1)).astype(np.float32)
    cr[80:100] = 1.0
    return cr


@pytest.mark.parametrize("f", [1.0, 0.5, 1.5, 4.0])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_fairness_limit_eq3(f, S):
    """Exact against the reference's compiled form, as its engine
    evaluates Eq. 3 (jitted, batched): its fused sum of squares and its
    fused ``mu - f * sigma`` reproduced."""
    cr = _rates(S, S=S)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda c: jeq.fairness_limit(c, f)))(jnp.asarray(cr)))
    got = to_np(teq.fairness_limit(torch.from_numpy(cr), f))
    np.testing.assert_array_equal(got, ref)


def test_fairness_limit_all_equal_is_mu():
    """sigma = 0 when every type has the same rate: epsilon = mu."""
    cr = np.full((3, 4), 0.75, np.float32)
    got = to_np(teq.fairness_limit(torch.from_numpy(cr), 1.0))
    np.testing.assert_array_equal(got, np.full(3, 0.75, np.float32))
    assert float(jeq.fairness_limit(jnp.asarray(cr[0]), 1.0)) == 0.75


@pytest.mark.parametrize("f", [1.0, 2.0])
def test_suffered_types_alg4(f):
    r = np.random.default_rng(7)
    comp = r.integers(0, 40, (600, 4))
    arr = comp + r.integers(0, 40, (600, 4))
    arr[:30] = 0                               # no arrivals yet: rate 1.0
    comp[:30] = 0
    comp[30:60] = arr[30:60] // 2              # all-equal rates (ties)
    arr[30:60] = arr[30:60, :1]
    comp[30:60] = comp[30:60, :1]
    ref = np.stack([np.asarray(jfair.suffered_types(
        jnp.asarray(c.astype(np.int32)), jnp.asarray(a.astype(np.int32)), f))
        for c, a in zip(comp, arr)])
    got = tfair.suffered_types(torch.from_numpy(comp), torch.from_numpy(arr),
                               f)
    np.testing.assert_array_equal(to_np(got), ref)


def test_completion_rates_and_jain():
    r = np.random.default_rng(8)
    comp = r.integers(0, 10, (50, 4))
    arr = comp + r.integers(0, 10, (50, 4))
    arr[:5] = 0
    comp[:5] = 0
    ref = np.stack([np.asarray(jfair.completion_rates(c, a))
                    for c, a in zip(comp, arr)])
    got = to_np(tfair.completion_rates(torch.from_numpy(comp),
                                       torch.from_numpy(arr)))
    np.testing.assert_array_equal(got, ref)
    jain_ref = np.array([float(jfair.jain_index(v)) for v in ref])
    np.testing.assert_allclose(to_np(tfair.jain_index(torch.from_numpy(got))),
                               jain_ref, rtol=1e-6)
