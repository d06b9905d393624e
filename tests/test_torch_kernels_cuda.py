"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the scheduling kernels bit for bit, the federation's
``balance_scan`` and per-row EET form included, and the model kernels
(flash attention, decode attention, the SSD scan) within
``tests/test_kernels.py``'s tolerances. Imports nothing of JAX, so it
runs where only PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device the test skips. ``kernel_inputs`` is shared with
``tests/test_torch_map_kernels.py``, which holds the plain versions
against the JAX package's kernels on the CPU.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    decode_attention,
    flash_attention,
    map_fused,
    phase1_map,
    ssm_scan,
)
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


def card_normal(shape, seed, dtype=torch.float32, scale=0.5):
    r = np.random.default_rng(seed)
    a = (r.standard_normal(shape) * scale).astype(np.float32)
    return torch.as_tensor(a, device="cuda").to(dtype)


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd,q_offset", [
    (128, 128, 4, 2, 64, 0), (256, 256, 8, 1, 32, 0), (64, 192, 4, 2, 128, 0),
    (100, 130, 4, 4, 80, 30), (32, 128, 2, 2, 16, 64),
])
def test_flash_attention_matches_plain_on_card(Sq, Sk, H, Hkv, hd, q_offset,
                                               dtype):
    """Causal and not, with and without a ragged kv_len, GQA, head dims
    that are not powers of two, Sq and Sk off the block grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    q = card_normal((2, Sq, H, hd), Sq, dtype)
    k = card_normal((2, Sk, Hkv, hd), Sk, dtype)
    v = card_normal((2, Sk, Hkv, hd), Sk + 1, dtype)
    kv_len = torch.tensor([Sk, max(1, Sk // 2 + 3)], dtype=torch.int32,
                          device="cuda")
    for causal in (True, False):
        for kl in (None, kv_len):
            kw = dict(causal=causal, kv_len=kl, q_offset=q_offset)
            got = flash_attention.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention.flash_attention_plain(q, k, v, **kw)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sk,H,Hkv,hd", [
    (256, 4, 4, 64), (512, 8, 2, 64), (1024, 4, 1, 128), (192, 2, 2, 32),
    (1088, 8, 8, 80), (300, 4, 2, 256),
])
def test_decode_attention_matches_plain_on_card(Sk, H, Hkv, hd, dtype):
    """Ragged kv_len, a row with none (the mean of V, as on the TPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    q = card_normal((3, 1, H, hd), Sk, dtype)
    k = card_normal((3, Sk, Hkv, hd), Sk + 1, dtype)
    v = card_normal((3, Sk, Hkv, hd), Sk + 2, dtype)
    kv_len = torch.tensor([Sk, 0, Sk // 3 + 1], dtype=torch.int32,
                          device="cuda")
    got = decode_attention.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,P,N,chunk", [
    (64, 2, 32, 16, 16), (128, 4, 64, 64, 32), (96, 1, 16, 8, 32),
    (256, 2, 64, 32, 128), (512, 8, 64, 64, 128),
])
def test_ssm_scan_matches_plain_on_card(L, H, P, N, chunk, dtype):
    """``tests/test_kernels.py``'s shapes and distributions; y in x's
    dtype, the final state in float32 (atol 2e-4, bf16 y 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    r = np.random.default_rng(L + H + P)
    x = card_normal((2, L, H, P), L, dtype)
    dt = torch.nn.functional.softplus(card_normal((2, L, H), L + 1,
                                                  scale=1.0))
    A = -torch.exp(torch.as_tensor(
        (r.standard_normal(H) * 0.3).astype(np.float32), device="cuda"))
    Bm = card_normal((2, L, N), L + 2)
    Cm = card_normal((2, L, N), L + 3)
    y, S = ssm_scan.ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    wy, wS = ssm_scan.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.dtype == dtype and S.dtype == torch.float32
    torch.testing.assert_close(
        y.float(), wy.float(), rtol=0,
        atol=2e-4 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(S, wS, rtol=0, atol=2e-4)
