"""The port's map-decision kernels held against the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version, which must
equal the Pallas kernel (run in interpret mode, as the JAX package's own
tests run it) bit for bit: every nominator x key x drop-rule kind, ragged
N (not a multiple of 128), M in {1, 4, 37}, forced ties and negative
urgency keys. The federation's per-row form (an EET table and powers per
replicate row) equals the Pallas kernel run row by row with each row's
table. The CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_kernels_cuda.py``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.map_fused import evict_stats as jax_evict_stats
from repro.kernels.map_fused import map_decide as jax_map_decide
from repro.kernels.phase1_map.ops import phase1_map as jax_phase1_map
from repro_torch.core.equations import BIG
from repro_torch.kernels import map_fused, phase1_map
from repro_torch.kernels.map_fused import ops as mf
from test_torch_kernels_cuda import kernel_inputs

torch.set_num_threads(1)

B, N, S = 2, 130, 4
ALL_KINDS = list(itertools.product(mf.NOMINATOR_KINDS, mf.KEY_KINDS,
                                   mf.DROP_KINDS))
SOME_KINDS = [("min_energy_feasible", "value", "stale_hopeless"),
              ("min_completion", "urgency", "stale"),
              ("min_execution", "deadline", "stale"),
              ("random_hash", "fcfs", "stale_hopeless")]
CASES = ([(4, k) for k in ALL_KINDS]
         + [(m, k) for m in (1, 37) for k in SOME_KINDS])


def _inputs(M, seed=0):
    return kernel_inputs(B, N, M, S, seed)


def _torch(x, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in x.items()}


def _md_args(t):
    return (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
            t["deadline"], t["pending"], t["task_type"])


@pytest.mark.parametrize("M,kinds", CASES,
                         ids=[f"M{m}-{'-'.join(k)}" for m, k in CASES])
def test_map_decide_plain_matches_pallas(M, kinds):
    nom, key, drop = kinds
    x = _inputs(M)
    t = _torch(x)
    for suffered in (t["suffered"], torch.zeros_like(t["suffered"])):
        got = map_fused.map_decide(*_md_args(t), suffered, nominator=nom,
                                   phase2_key=key, drop_rule=drop)
        for b in range(B):
            ref = jax_map_decide(
                jnp.float32(x["now"][b]), jnp.asarray(x["start"][b]),
                jnp.asarray(x["p_dyn"]), jnp.asarray(x["qfree"][b]),
                jnp.asarray(x["eet"]), jnp.asarray(x["deadline"][b]),
                jnp.asarray(x["pending"][b]),
                jnp.asarray(x["task_type"][b].astype(np.int32)),
                jnp.asarray(suffered[b].numpy()), nominator=nom,
                phase2_key=key, drop_rule=drop, interpret=True)
            for i, (g, r) in enumerate(zip(got, ref)):
                np.testing.assert_array_equal(
                    g[b].numpy(), np.asarray(r),
                    err_msg=f"output {i} replicate {b} {kinds} M={M}")


@pytest.mark.parametrize("M", [1, 4, 37])
def test_evict_stats_plain_matches_pallas(M):
    x = _inputs(M, seed=1)
    t = _torch(x)
    feas, min_exec = map_fused.evict_stats(
        t["start"], t["qfree"], t["eet"], t["deadline"], t["pending"],
        t["task_type"])
    for b in range(B):
        rf, rm = jax_evict_stats(
            jnp.asarray(x["start"][b]), jnp.asarray(x["qfree"][b]),
            jnp.asarray(x["eet"]), jnp.asarray(x["deadline"][b]),
            jnp.asarray(x["pending"][b]),
            jnp.asarray(x["task_type"][b].astype(np.int32)), interpret=True)
        np.testing.assert_array_equal(feas[b].numpy(), np.asarray(rf))
        np.testing.assert_array_equal(min_exec[b].numpy(), np.asarray(rm))


@pytest.mark.parametrize("M", [1, 4, 37])
def test_phase1_map_plain_matches_pallas(M):
    x = _inputs(M, seed=2)
    t = _torch(x)
    rows = t["eet"][t["task_type"]]
    best_m, best_ec = phase1_map.phase1_map(
        t["start"], rows, t["deadline"], t["p_dyn"], t["pending"],
        t["qfree"])
    for b in range(B):
        rm, re = jax_phase1_map(
            jnp.asarray(x["start"][b]), jnp.asarray(rows[b].numpy()),
            jnp.asarray(x["deadline"][b]), jnp.asarray(x["p_dyn"]),
            jnp.asarray(x["pending"][b]), jnp.asarray(x["qfree"][b]),
            interpret=True)
        np.testing.assert_array_equal(best_m[b].numpy(), np.asarray(rm))
        np.testing.assert_array_equal(best_ec[b].numpy(), np.asarray(re))


def _per_row(M, seed):
    """Inputs with one (S, M) EET table and (M,) powers per row, as the
    engine's site views have them: row 1's second half of the machines
    reads BIG, as a masked view's other site does."""
    x = _inputs(M, seed)
    r = np.random.default_rng(seed)
    eet = (np.round(r.uniform(0.5, 5.0, (B, S, M)) * 8) / 8).astype(
        np.float32)
    eet[:, :, -1] = eet[:, :, 0]
    eet[1, :, M // 2:] = BIG
    x["eet"] = eet
    x["p_dyn"] = r.choice([1.5, 1.6, 3.0], (B, M)).astype(np.float32)
    return x


PER_ROW_CASES = ([(4, k) for k in ALL_KINDS]
                 + [(20, k) for k in SOME_KINDS])


@pytest.mark.parametrize("M,kinds", PER_ROW_CASES,
                         ids=[f"M{m}-{'-'.join(k)}" for m, k in PER_ROW_CASES])
def test_per_row_map_decide_matches_pallas(M, kinds):
    nom, key, drop = kinds
    x = _per_row(M, seed=3)
    t = _torch(x)
    got = map_fused.map_decide(*_md_args(t), t["suffered"], nominator=nom,
                               phase2_key=key, drop_rule=drop)
    for b in range(B):
        ref = jax_map_decide(
            jnp.float32(x["now"][b]), jnp.asarray(x["start"][b]),
            jnp.asarray(x["p_dyn"][b]), jnp.asarray(x["qfree"][b]),
            jnp.asarray(x["eet"][b]), jnp.asarray(x["deadline"][b]),
            jnp.asarray(x["pending"][b]),
            jnp.asarray(x["task_type"][b].astype(np.int32)),
            jnp.asarray(x["suffered"][b]), nominator=nom, phase2_key=key,
            drop_rule=drop, interpret=True)
        for i, (g, r) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(
                g[b].numpy(), np.asarray(r),
                err_msg=f"output {i} replicate {b} {kinds} M={M}")


@pytest.mark.parametrize("M", [4, 20])
def test_per_row_evict_stats_matches_pallas(M):
    x = _per_row(M, seed=4)
    t = _torch(x)
    feas, min_exec = map_fused.evict_stats(
        t["start"], t["qfree"], t["eet"], t["deadline"], t["pending"],
        t["task_type"])
    for b in range(B):
        rf, rm = jax_evict_stats(
            jnp.asarray(x["start"][b]), jnp.asarray(x["qfree"][b]),
            jnp.asarray(x["eet"][b]), jnp.asarray(x["deadline"][b]),
            jnp.asarray(x["pending"][b]),
            jnp.asarray(x["task_type"][b].astype(np.int32)), interpret=True)
        np.testing.assert_array_equal(feas[b].numpy(), np.asarray(rf))
        np.testing.assert_array_equal(min_exec[b].numpy(), np.asarray(rm))


def test_cpu_path_never_counts_launches():
    before = dict(mf.LAUNCHES), dict(phase1_map.LAUNCHES)
    t = _torch(_inputs(4))
    map_fused.map_decide(*_md_args(t), t["suffered"],
                         nominator="min_completion", phase2_key="value",
                         drop_rule="stale")
    map_fused.balance_scan(torch.zeros(B, 3, dtype=torch.int64),
                           t["pending"], t["pending"], t["task_type"] % 3)
    assert (dict(mf.LAUNCHES), dict(phase1_map.LAUNCHES)) == before


def test_wrapper_rejects_unknown_kind():
    t = _torch(_inputs(4))
    with pytest.raises(ValueError, match="nominator"):
        map_fused.map_decide(*_md_args(t), t["suffered"], nominator="nope",
                             phase2_key="value", drop_rule="stale")
