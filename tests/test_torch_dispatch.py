"""Dispatch layer parity: the port's batched ``DispatchContext``, its seven
built-in dispatchers and the least-loaded balance walk against the JAX
package's (``repro.core.dispatch``) on random contexts.

Each context carries B replicates; the JAX side is called once per
replicate on the same numpy arrays. Partitions: contiguous with F in
{2, 3, 8}, and an interleaved one (0, 1, 0, 1) that only the masked
fold can serve. Every comparison is exact (integer loads and sites,
float32 minima of the same values).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core.dispatch import DispatchContext as JaxContext
from repro.core.dispatch import sequential_balance as jax_balance
from repro.core.dispatch.builtins import _hash_sites as jax_hash_sites
from repro.core.types import site_membership as jax_site_membership
from repro.kernels.map_fused import balance_scan as jax_balance_scan
from repro_torch import interop
from repro_torch.core import dispatch
from repro_torch.core.dispatch.builtins import _hash_sites
from repro_torch.core.types import site_membership
from repro_torch.kernels import map_fused
from repro_torch.kernels.map_fused import ops as mf

torch.set_num_threads(1)

B, N, S = 3, 70, 4
PARTITIONS = {
    "F2": (0, 0, 0, 0, 1, 1, 1, 1),
    "F3": (0, 0, 1, 1, 1, 2),
    "F8": tuple(f for f in range(8) for _ in range(4)),
    "interleaved": (0, 1, 0, 1),
}
BUILTINS = ("sticky", "round_robin", "least_queued", "min_eet",
            "fair_spill", "health_aware", "tier_aware")
WALKERS = ("least_queued", "fair_spill", "health_aware")


def _arrays(sites, seed):
    """B random dispatch events as numpy arrays: tied EET columns, some
    suffered types, idle and saturated machines."""
    r = np.random.default_rng(seed)
    M = len(sites)
    eet = r.uniform(0.5, 20, (S, M)).astype(np.float32)
    eet[:, M - 1] = eet[:, 0]
    return dict(
        now=r.uniform(0, 50, B).astype(np.float32),
        unassigned=r.random((B, N)) < 0.4,
        task_type=r.integers(0, S, (B, N)),
        deadline=r.uniform(0, 120, (B, N)).astype(np.float32),
        qlen=r.integers(0, 3, (B, M)),
        running=r.random((B, M)) < 0.5,
        completed=r.integers(0, 20, (B, S)),
        arrived=r.integers(20, 40, (B, S)),
        eet=eet,
        site_of_machine=np.asarray(sites),
        n_sites=max(sites) + 1,
    )


def _jax_ctx(a, b, alive=None):
    return JaxContext(
        now=jnp.float32(a["now"][b]),
        unassigned=jnp.asarray(a["unassigned"][b]),
        task_type=jnp.asarray(a["task_type"][b].astype(np.int32)),
        deadline=jnp.asarray(a["deadline"][b]),
        qlen=jnp.asarray(a["qlen"][b].astype(np.int32)),
        running=jnp.asarray(a["running"][b]),
        completed=jnp.asarray(a["completed"][b].astype(np.int32)),
        arrived=jnp.asarray(a["arrived"][b].astype(np.int32)),
        eet=jnp.asarray(a["eet"]),
        site_of_machine=a["site_of_machine"],
        n_sites=a["n_sites"],
        fairness_factor=1.0,
        alive=None if alive is None else jnp.asarray(alive),
    )


def _port_ctx(a):
    return interop.dispatch_context_from_arrays(**a, device="cpu")


@pytest.mark.parametrize("name", list(PARTITIONS))
def test_site_membership_matches_jax(name):
    sites = PARTITIONS[name]
    np.testing.assert_array_equal(site_membership(sites),
                                  jax_site_membership(sites))
    np.testing.assert_array_equal(site_membership(sites, 9),
                                  jax_site_membership(sites, 9))


@pytest.mark.parametrize("name", list(PARTITIONS))
def test_context_aggregates_match_jax(name):
    a = _arrays(PARTITIONS[name], seed=len(name))
    ctx = _port_ctx(a)
    for field in ("site_queued", "site_running", "site_load", "suffered"):
        got = getattr(ctx, field).numpy()
        for b in range(B):
            np.testing.assert_array_equal(
                got[b], np.asarray(getattr(_jax_ctx(a, b), field)),
                err_msg=f"{field} replicate {b}")
    np.testing.assert_array_equal(ctx.eet_min_by_site.numpy(),
                                  np.asarray(_jax_ctx(a, 0).eet_min_by_site))
    np.testing.assert_array_equal(ctx.site_members.numpy(),
                                  jax_site_membership(PARTITIONS[name]))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("kind", BUILTINS)
@pytest.mark.parametrize("name", list(PARTITIONS))
def test_dispatchers_match_jax(name, kind, fused):
    """Every built-in, batched, equals the JAX dispatcher run replicate by
    replicate; ``with_fused_balance`` (the plain walk on the CPU) changes
    nothing."""
    a = _arrays(PARTITIONS[name], seed=7 + len(kind))
    d = dispatch.get(kind)
    if fused:
        d = dispatch.with_fused_balance(d)
    got = np.broadcast_to(d.dispatch(_port_ctx(a)).numpy(), (B, N))
    ref = jdispatch.get(kind)
    for b in range(B):
        np.testing.assert_array_equal(
            got[b], np.asarray(ref.dispatch(_jax_ctx(a, b))),
            err_msg=f"{kind} replicate {b}")


@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
@pytest.mark.parametrize("F", [2, 3, 8, 37])
def test_balance_walk_matches_lax_scan_and_pallas(F, density):
    """The plain walk equals the JAX ``lax.scan`` walk and the Pallas
    kernel in interpret mode, row by row, with dead sites entering at
    +1,000,000 (the JAX context's health penalty) and ties everywhere."""
    sites = tuple(range(F)) + tuple(range(F))
    a = _arrays(sites, seed=F)
    r = np.random.default_rng(100 + F)
    a["unassigned"] = r.random((B, N)) < density
    alive = r.random((B, 2 * F)) < 0.6
    for b in range(B):                  # site b % F down, the next one up
        alive[b, [b % F, F + b % F]] = False
        alive[b, (b + 1) % F] = True
    target = r.random((B, N)) < 0.5
    target[0] = True
    home = r.integers(0, F, (B, N))
    load0, ref = [], []
    for b in range(B):
        ctx = _jax_ctx(a, b, alive[b])
        penalty = jnp.where(ctx.site_alive, 0, 1_000_000)
        load0.append(np.asarray(ctx.site_load + penalty))
        tgt = jnp.asarray(target[b])
        hm = jnp.asarray(home[b].astype(np.int32))
        walk = np.asarray(jax_balance(ctx, tgt, hm))
        kernel = np.asarray(jax_balance_scan(
            jnp.asarray(load0[-1]), ctx.unassigned, tgt, hm, interpret=True))
        np.testing.assert_array_equal(walk, kernel)
        ref.append(walk)
    load0 = np.stack(load0)
    assert (load0 >= 1_000_000).any() and (load0 < 1_000_000).any()
    args = (torch.as_tensor(load0.astype(np.int64)),
            torch.as_tensor(a["unassigned"]), torch.as_tensor(target),
            torch.as_tensor(home))
    got = map_fused.balance_scan(*args)
    np.testing.assert_array_equal(got.numpy(), np.stack(ref))
    bound = int(a["unassigned"].sum(1).max())
    np.testing.assert_array_equal(
        mf.balance_scan_plain(*args, max_new=bound).numpy(), np.stack(ref))


def test_hash_homes_wrap_like_uint32():
    """Hash homes past 2^32 / 2654435761 tasks wrap mod 2^32, with the
    salt added before the modulus."""
    for n_sites, salt in ((3, 0), (8, 7), (5, 2**31 + 3)):
        got = _hash_sites(2, 5000, n_sites, salt, torch.device("cpu"))
        ref = np.asarray(jax_hash_sites(5000, n_sites, salt))
        np.testing.assert_array_equal(got.numpy(), np.stack([ref, ref]))


@pytest.mark.parametrize("kind", BUILTINS)
def test_with_fused_balance_and_json_round_trip(kind):
    d = dispatch.get(kind)
    fused = dispatch.with_fused_balance(d)
    if kind in WALKERS:
        assert fused.balance_impl is map_fused.balance_scan
        assert d.balance_impl is None
    else:
        assert fused is d
    payload = dispatch.to_json_dict(fused)
    assert payload == jdispatch.to_json_dict(kind)
    assert dispatch.from_json_dict(payload) == d


def test_registry_and_resolve():
    assert dispatch.list_dispatchers() == sorted(BUILTINS)
    assert dispatch.list_dispatchers() == jdispatch.list_dispatchers()
    assert dispatch.resolve(None) == dispatch.Sticky()
    assert dispatch.resolve("FAIR_SPILL") == dispatch.FairSpill()
    custom = dispatch.Sticky(salt=5, by_type=True)
    assert dispatch.resolve(custom) is custom
    assert dispatch.from_json_dict(dispatch.to_json_dict(custom)) == custom
    for name in BUILTINS:
        assert dispatch.describe(name) and not dispatch.describe(name) \
            .endswith(".")
    with pytest.raises(KeyError, match="sticky"):
        dispatch.get("BOGUS")
    with pytest.raises(TypeError):
        dispatch.resolve(42)
    with pytest.raises(ValueError, match="unknown dispatcher kind"):
        dispatch.from_json_dict({"kind": "nope"})


def test_context_refuses_unported_fields():
    """No field is refused any more: the network's per-task link costs
    (``xfer_lat``, ``xfer_energy``, (B, N, F)) are carried as given, and
    the health fields derive the heartbeat mask."""
    a = _arrays(PARTITIONS["F2"], seed=0)
    ctx = _port_ctx(a)
    assert ctx.xfer_lat is None and ctx.xfer_energy is None
    for name in ("xfer_lat", "xfer_energy"):
        links = torch.ones(B, N, 2)
        assert getattr(dataclasses.replace(ctx, **{name: links}),
                       name) is links
    assert ctx.site_alive is None
    alive = torch.ones(B, 8, dtype=torch.bool)
    alive[0, :4] = False
    got = dataclasses.replace(ctx, alive=alive).site_alive
    assert got.tolist() == [[False, True]] + [[True, True]] * (B - 1)


def _health_arrays(a, seed):
    """Per-replicate health for :func:`_arrays`: random dead machines (a
    whole site down in replicate 0, every machine of the last site up),
    and each replicate's EET masked by it and scaled by stragglers, as
    the engine hands it over."""
    r = np.random.default_rng(seed)
    sites = a["site_of_machine"]
    alive = r.random((B, len(sites))) < 0.6
    alive[0, sites == 0] = False
    alive[:, sites == sites.max()] = True
    slow = np.where(r.random((B, len(sites))) < 0.3, np.float32(1.5),
                    np.float32(1.0)).astype(np.float32)
    eet = np.where(alive[:, None, :], a["eet"][None] * slow[:, None, :],
                   np.float32(1e30)).astype(np.float32)
    return alive, eet


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("kind", BUILTINS)
@pytest.mark.parametrize("name", list(PARTITIONS))
def test_dispatchers_match_jax_under_faults(name, kind, fused):
    """Under machine dynamics: the site heartbeat, the dead-site penalty
    of the balance walk, ``health_aware``'s re-route and per-replicate
    site minima (``min_eet``, ``tier_aware``) equal the JAX dispatcher's
    on each replicate's own health and masked EET."""
    a = _arrays(PARTITIONS[name], seed=11 + len(kind))
    alive, eet = _health_arrays(a, seed=len(name))
    ctx = dataclasses.replace(_port_ctx(a), alive=torch.as_tensor(alive),
                              eet=torch.as_tensor(eet))
    d = dispatch.get(kind)
    if fused:
        d = dispatch.with_fused_balance(d)
    got = np.broadcast_to(d.dispatch(ctx).numpy(), (B, N))
    ref = jdispatch.get(kind)
    for b in range(B):
        jctx = dataclasses.replace(_jax_ctx(a, b, alive[b]),
                                   eet=jnp.asarray(eet[b]))
        np.testing.assert_array_equal(
            got[b], np.asarray(ref.dispatch(jctx)),
            err_msg=f"{kind} replicate {b}")
        np.testing.assert_array_equal(ctx.site_alive[b].numpy(),
                                      np.asarray(jctx.site_alive))
        np.testing.assert_array_equal(ctx.eet_min_by_site[b].numpy(),
                                      np.asarray(jctx.eet_min_by_site))
