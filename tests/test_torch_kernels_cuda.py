"""The port's CUDA kernels against their plain PyTorch versions, on the
card, bit for bit, the federation's ``balance_scan`` and per-row EET form
included. Imports nothing of JAX, so it runs where only PyTorch
and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device the test skips. ``kernel_inputs`` is shared with
``tests/test_torch_map_kernels.py``, which holds the plain versions
against the JAX package's kernels on the CPU.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import map_fused, phase1_map
from repro_torch.kernels.map_fused import ops as mf

ALL_KINDS = list(itertools.product(mf.NOMINATOR_KINDS, mf.KEY_KINDS,
                                   mf.DROP_KINDS))


def kernel_inputs(B, N, M, S, seed=0):
    """Numpy inputs for B replicates: tied EET columns and start times,
    quantized deadlines (tied keys), stale tasks, full machines, and
    deadlines on both sides of now + e (urgency keys of both signs)."""
    r = np.random.default_rng(seed + M)
    f32 = np.float32
    eet = (np.round(r.uniform(0.5, 5.0, (S, M)) * 8) / 8).astype(f32)
    if M > 1:
        eet[:, M - 1] = eet[:, 0]
    now = (np.round(r.uniform(0, 50, B) * 4) / 4).astype(f32)
    start = (now[:, None] + r.choice([0.0, 0.5, 1.0, 2.5], (B, M))
             ).astype(f32)
    qfree = r.random((B, M)) < 0.7
    qfree[:, 0] = True
    return dict(
        now=now, start=start,
        p_dyn=r.choice([1.5, 1.6, 3.0], M).astype(f32), qfree=qfree,
        eet=eet,
        deadline=(now[:, None] + r.choice(np.arange(-4.0, 12.0, 0.5),
                                          (B, N))).astype(f32),
        pending=r.random((B, N)) < 0.8,
        task_type=r.integers(0, S, (B, N)).astype(np.int64),
        suffered=r.random((B, N)) < 0.3,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 37])
def test_cuda_kernels_match_plain_on_card(M):
    """Each CUDA kernel equals its plain version on the card (built from
    the checkout's sources on first use)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    t = {k: torch.as_tensor(v, device="cuda")
         for k, v in kernel_inputs(3, 300, M, 4).items()}
    md = (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
          t["deadline"], t["pending"], t["task_type"])
    for nom, key, drop in ALL_KINDS:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        for suffered in (t["suffered"], torch.zeros_like(t["suffered"])):
            got = map_fused.map_decide(*md, suffered, **kw)
            torch.cuda.synchronize()
            want = map_fused.map_decide_plain(*md, suffered, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (M, kw)
    es = (t["start"], t["qfree"], t["eet"], t["deadline"], t["pending"],
          t["task_type"])
    for g, w in zip(map_fused.evict_stats(*es),
                    map_fused.evict_stats_plain(*es)):
        assert torch.equal(g, w)
    p1 = (t["start"], t["eet"][t["task_type"]].contiguous(), t["deadline"],
          t["p_dyn"], t["pending"], t["qfree"])
    for g, w in zip(phase1_map.phase1_map(*p1),
                    phase1_map.phase1_map_plain(*p1)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [8, 37])
def test_balance_scan_matches_plain_on_card(F):
    """The balance walk equals its plain version on the card: sparse to
    full admissions, tied loads (replicate 0), dead sites at +1,000,000,
    N not a multiple of 32, F above one warp's lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    r = np.random.default_rng(F)
    B, N = 5, 1001
    for density in (0.01, 0.5, 1.0):
        load0 = r.integers(0, 6, (B, F)) \
            + 1_000_000 * (r.random((B, F)) < 0.25)
        load0[0] = 3
        target = r.random((B, N)) < 0.5
        target[1] = True
        args = [torch.as_tensor(a, device="cuda") for a in (
            load0.astype(np.int64), r.random((B, N)) < density, target,
            r.integers(0, F, (B, N)).astype(np.int64))]
        got = map_fused.balance_scan(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, map_fused.balance_scan_plain(*args)), density


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 20])
def test_per_row_map_kernels_match_plain_on_card(M):
    """The per-row EET form (one (S, M) table and (M,) powers per row, as
    the federation's site views have them) equals the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    x = kernel_inputs(6, 300, M, 4, seed=9)
    r = np.random.default_rng(M)
    x["eet"] = (np.round(r.uniform(0.5, 5.0, (6, 4, M)) * 8) / 8).astype(
        np.float32)
    x["p_dyn"] = r.choice([1.5, 1.6, 3.0], (6, M)).astype(np.float32)
    t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    md = (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
          t["deadline"], t["pending"], t["task_type"])
    for nom, key, drop in ALL_KINDS:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        got = map_fused.map_decide(*md, t["suffered"], **kw)
        torch.cuda.synchronize()
        want = map_fused.map_decide_plain(*md, t["suffered"], **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (M, kw)
    es = (t["start"], t["qfree"], t["eet"], t["deadline"], t["pending"],
          t["task_type"])
    for g, w in zip(map_fused.evict_stats(*es),
                    map_fused.evict_stats_plain(*es)):
        assert torch.equal(g, w)
