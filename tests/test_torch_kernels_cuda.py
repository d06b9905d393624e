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
from functools import partial

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
        # drawn as int64, kept as int32 (the type the kernels take)
        task_type=r.integers(0, S, (B, N)).astype(np.int32),
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
@pytest.mark.parametrize("F", [1, 8, 32, 37, 1024])
def test_balance_scan_matches_plain_on_card(F):
    """The balance walk equals its plain version on the card: no, sparse
    and full admissions, tied loads (replicate 0), dead sites at
    +1,000,000, N off the 16-task vector grain, F from one site to 32 per
    lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    r = np.random.default_rng(F)
    B, N = 5, 1001
    for density in (0.0, 0.01, 0.5, 1.0):
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
@pytest.mark.parametrize("loads", ["dead", "wide"])
@pytest.mark.parametrize("B,N,F", [(3, 10_000, 8), (4, 4097, 37),
                                   (2, 9000, 1024), (150, 4000, 8)])
def test_balance_scan_tiles_and_key_widths_on_card(B, N, F, loads):
    """More new tasks than one 4096-task tile (every task new, and half of
    them), the federated path's shape, and both walks: loads with dead
    sites (packed 32-bit keys) and loads from 2^22 up (64-bit pairs)."""
    needs_card()
    r = np.random.default_rng(N + F)
    base = (1 << 22) if loads == "wide" else 0
    for density in (0.5, 1.0):
        load0 = base + r.integers(0, 6, (B, F)) \
            + 1_000_000 * (r.random((B, F)) < 0.25)
        args = [torch.as_tensor(a, device="cuda") for a in (
            load0.astype(np.int64), r.random((B, N)) < density,
            r.random((B, N)) < 0.5, r.integers(-1, F + 1, (B, N)))]
        got = map_fused.balance_scan(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, map_fused.balance_scan_plain(*args)), density


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("M", [1, 3, 4, 20, 37])
def test_evict_stats_edges_on_card(M, per_row):
    """evict_stats bit for bit with a row without a free machine, deadlines
    exactly start + e of a free machine and deadlines of +inf, on shared
    and per-row tables (BIG columns), N off the 4-task grain, and on
    unaligned task arrays (one task at a time)."""
    needs_card()
    B, N, S = 150, 2001, 4
    x = kernel_inputs(B, N + 1, M, S, seed=M)
    r = np.random.default_rng(M)
    x["qfree"][0] = False
    if per_row:
        eet = np.round(r.uniform(0.5, 5.0, (B, S, M)) * 8) / 8
        eet[:, :, M // 2:] = 1e30
        x["eet"] = eet.astype(np.float32)
    e = np.broadcast_to(x["eet"], (B, S, M))
    m = r.integers(0, M, (B, N + 1))
    rows = np.arange(B)[:, None]
    exact = x["start"][rows, m] + e[rows, x["task_type"], m]
    pick = r.random((B, N + 1))
    d = np.where(pick < 0.3, exact, x["deadline"])
    x["deadline"] = np.where(pick > 0.9, np.inf, d).astype(np.float32)
    t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    task = {k: t[k][:, :N].contiguous()
            for k in ("deadline", "pending", "task_type")}
    shifted = {k: t[k].reshape(-1)[1:1 + B * N].view(B, N)
               for k in ("deadline", "pending", "task_type")}
    for arrays in (task, shifted):
        es = (t["start"], t["qfree"], t["eet"], arrays["deadline"],
              arrays["pending"], arrays["task_type"])
        got = map_fused.evict_stats(*es)
        torch.cuda.synchronize()
        for g, w in zip(got, map_fused.evict_stats_plain(*es)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_scheduling_kernels_take_int32_types_on_card():
    """On the card map_decide and evict_stats take int32 task types, the
    type the port keeps, and refuse int64 ones rather than cast."""
    needs_card()
    t = {k: torch.as_tensor(v, device="cuda")
         for k, v in kernel_inputs(2, 64, 4, 4).items()}
    assert t["task_type"].dtype == torch.int32
    wide = t["task_type"].to(torch.int64)
    with pytest.raises(TypeError, match="task_type"):
        map_fused.evict_stats(t["start"], t["qfree"], t["eet"],
                              t["deadline"], t["pending"], wide)
    with pytest.raises(TypeError, match="task_type"):
        map_fused.map_decide(
            t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
            t["deadline"], t["pending"], wide, t["suffered"],
            nominator="min_completion", phase2_key="value",
            drop_rule="stale")


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


def bf16_attention_bound(plain, q, k, v):
    """Per element, how far a bf16 attention kernel may lie from the plain
    version (as in ``chip_smoke.py``): 2^-8 |x| for each of the two bf16
    roundings of the float32 output x, 2^-8 sum_j p_j |v_j| / l (the plain
    version on |v|) for rounding p before P.V, and 2^-11 of that for
    float32 sums in another order."""
    qf, kf, vf = q.float(), k.float(), v.float()
    return (2.0 ** -7 * plain(qf, kf, vf).abs()
            + (2.0 ** -8 + 2.0 ** -11) * plain(qf, kf, vf.abs()))


def assert_attention_close(got, plain, q, k, v):
    """``got`` against ``plain(q, k, v)``: within atol 1e-5 in float32; in
    bf16 within 2e-2 and, element by element, within the bf16 bound."""
    torch.cuda.synchronize()
    want = plain(q, k, v)
    assert got.dtype == want.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATTN_TOL[q.dtype])
    if q.dtype == torch.bfloat16:
        excess = (got.float() - want.float()).abs() \
            / bf16_attention_bound(plain, q, k, v)
        assert float(excess.max()) <= 1.0, float(excess.max())


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
            assert_attention_close(got, flash_plain(**kw), q, k, v)


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
    assert_attention_close(got, decode_plain(kv_len), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,P,N,chunk", [
    (64, 2, 32, 16, 16), (128, 4, 64, 64, 32), (96, 1, 16, 8, 32),
    (256, 2, 64, 32, 128), (512, 8, 64, 64, 128),
])
def test_ssm_scan_matches_plain_on_card(L, H, P, N, chunk, dtype):
    """``tests/test_kernels.py``'s shapes and distributions; y in x's
    dtype, the final state in float32 (atol 2e-4; bf16 y as
    ``assert_ssd_matches_plain`` holds it)."""
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
    args = (x, dt, A, Bm, Cm)
    assert_ssd_matches_plain(args, chunk,
                             ssm_scan.ssm_scan(*args, chunk=chunk))


def flash_plain(**kw):
    return partial(flash_attention.flash_attention_plain, **kw)


def decode_plain(kv_len):
    return partial(decode_attention.decode_attention_plain, kv_len=kv_len)


def split_chunk(Sk):
    """Keys per block of the decode kernel's split over 8 blocks: ceil(Sk /
    8) rounded up to a multiple of 8."""
    return -(-(-(-Sk // 8)) // 8) * 8


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sk,hd", [(1088, 80), (4096, 128), (1089, 64)])
def test_decode_attention_split_boundaries_on_card(Sk, hd, dtype):
    """GQA with 8 query heads per kv head, kv_len at and around the
    boundaries of the 8 blocks' key chunks: none, one key, a chunk, a chunk
    and one, every key (chunks wholly past kv_len give empty partials)."""
    needs_card()
    c = split_chunk(Sk)
    lens = [0, 1, c, c + 1, 2 * c, 7 * c + 1, Sk - 1, Sk]
    B, H, Hkv = len(lens), 16, 2
    q = card_normal((B, 1, H, hd), Sk, dtype)
    k = card_normal((B, Sk, Hkv, hd), Sk + 1, dtype)
    v = card_normal((B, Sk, Hkv, hd), Sk + 2, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q, k, v, kv_len)
    assert_attention_close(got, decode_plain(kv_len), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [24, 40, 256])
def test_flash_attention_odd_head_dims_on_card(hd, dtype):
    """Head dims off the 16-column grain of the tensor-core kernel (24,
    40) and at its widest (256), causal and not, with every key, a ragged
    kv_len and a row with none."""
    needs_card()
    Sq, Sk, H, Hkv = 96, 130, 4, 2
    q = card_normal((3, Sq, H, hd), hd, dtype)
    k = card_normal((3, Sk, Hkv, hd), hd + 1, dtype)
    v = card_normal((3, Sk, Hkv, hd), hd + 2, dtype)
    kv_len = torch.tensor([Sk, 0, 71], dtype=torch.int32, device="cuda")
    for causal in (True, False):
        for kl in (None, kv_len):
            kw = dict(causal=causal, kv_len=kl, q_offset=Sk - Sq)
            got = flash_attention.flash_attention(q, k, v, **kw)
            assert_attention_close(got, flash_plain(**kw), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_single_query_row_on_card(dtype):
    """Sq = 1 without the causal mask: one row of one warpgroup's 64."""
    needs_card()
    q = card_normal((4, 1, 8, 80), 5, dtype)
    k = card_normal((4, 200, 2, 80), 6, dtype)
    v = card_normal((4, 200, 2, 80), 7, dtype)
    kv_len = torch.tensor([200, 0, 1, 65], dtype=torch.int32, device="cuda")
    for kl in (None, kv_len):
        got = flash_attention.flash_attention(q, k, v, causal=False,
                                              kv_len=kl)
        assert_attention_close(got, flash_plain(causal=False, kv_len=kl),
                               q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("qk_scale", [0.5, 2.5])
def test_flash_attention_serve_shape_on_card(qk_scale):
    """The serve path's prefill: B 8, S 1024, 32 heads of 80, bf16, with q
    and k spread as in tests/test_kernels.py and five times wider (a
    peaked softmax: outputs O(|v|), so a lost or stale tile shows)."""
    needs_card()
    q, k = (card_normal((8, 1024, 32, 80), s, torch.bfloat16, qk_scale)
            for s in (1, 2))
    v = card_normal((8, 1024, 32, 80), 3, torch.bfloat16)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert_attention_close(got, flash_plain(causal=True), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd,q_offset", [
    (200, 330, 4, 2, 80, 130), (64, 512, 8, 8, 64, 448),
    (130, 130, 4, 1, 40, 0),
])
def test_flash_attention_peaked_scores_on_card(Sq, Sk, H, Hkv, hd,
                                               q_offset):
    """bf16 with q and k at 2.5 N(0, 1): scores of std 6.25, so every key
    tile that a row reaches moves its output, ragged kv_len included."""
    needs_card()
    q = card_normal((3, Sq, H, hd), 11, torch.bfloat16, 2.5)
    k = card_normal((3, Sk, Hkv, hd), 12, torch.bfloat16, 2.5)
    v = card_normal((3, Sk, Hkv, hd), 13, torch.bfloat16)
    kv_len = torch.tensor([Sk, 0, Sk // 2 + 5], dtype=torch.int32,
                          device="cuda")
    for causal in (True, False):
        for kl in (None, kv_len):
            kw = dict(causal=causal, kv_len=kl, q_offset=q_offset)
            got = flash_attention.flash_attention(q, k, v, **kw)
            assert_attention_close(got, flash_plain(**kw), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_reads_strides_that_bar_wide_loads_on_card(dtype):
    """Views whose row stride is odd: no 16-byte copy or TMA box fits, so
    the kernels read element by element, with the same result."""
    needs_card()
    wide = card_normal((2, 130, 3, 81), 8, dtype)
    q = card_normal((2, 70, 3, 81), 9, dtype)[..., :80]
    k, v = wide[..., :80], wide[..., 1:]
    assert k.stride(1) % 2 == 1
    kv_len = torch.tensor([130, 57], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, kv_len=kv_len, q_offset=60)
    got = flash_attention.flash_attention(q, k, v, **kw)
    assert_attention_close(got, flash_plain(**kw), q, k, v)
    got = decode_attention.decode_attention(q[:, :1], k, v, kv_len)
    assert_attention_close(got, decode_plain(kv_len), q[:, :1], k, v)


@pytest.mark.cuda
def test_attention_wrappers_count_one_launch_per_call():
    """Each call on the card adds exactly one to its wrapper's count."""
    needs_card()
    q = card_normal((2, 64, 4, 80), 1, torch.bfloat16)
    k = card_normal((2, 64, 2, 80), 2, torch.bfloat16)
    kv_len = torch.tensor([64, 5], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd = q.to(dtype), k.to(dtype)
        for n in (1, 3):
            before = flash_attention.LAUNCHES["flash_attention"]
            for _ in range(n):
                flash_attention.flash_attention(qd, kd, kd, causal=True)
            assert flash_attention.LAUNCHES["flash_attention"] == before + n
            before = decode_attention.LAUNCHES["decode_attention"]
            for _ in range(n):
                decode_attention.decode_attention(qd[:, :1], kd, kd, kv_len)
            assert decode_attention.LAUNCHES["decode_attention"] \
                == before + n
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# The SSD scan's two routes, and map_decide's register / cluster design
# --------------------------------------------------------------------------
SSD_ROUTE_CASES = [  # B, L, H, P, N, chunk, route
    (8, 1024, 80, 64, 64, 128, "ssd_scan_tc"),   # the serve shape
    (2, 64, 2, 32, 16, 16, "ssd_scan_tc"),       # one row tile per chunk
    (2, 192, 3, 24, 32, 96, "ssd_scan_tc"),      # P off 16, Q off 32
    (2, 96, 1, 16, 8, 32, "ssd_scan"),           # N = 8
    (2, 64, 2, 20, 16, 32, "ssd_scan"),          # P not a multiple of 8
    (2, 64, 2, 32, 16, 8, "ssd_scan"),           # Q < 16
    (1, 256, 2, 64, 80, 128, "ssd_scan"),        # N above 64
]


def ssd_card_inputs(B, L, H, P, N, dtype, seed):
    r = np.random.default_rng(seed)
    x = card_normal((B, L, H, P), seed, dtype)
    dt = torch.nn.functional.softplus(card_normal((B, L, H), seed + 1,
                                                  scale=1.0))
    A = -torch.exp(torch.as_tensor(
        (r.standard_normal(H) * 0.3).astype(np.float32), device="cuda"))
    return x, dt, A, card_normal((B, L, N), seed + 2), \
        card_normal((B, L, N), seed + 3)


def bf16_ssd_bound(want):
    """Per element, how far the tensor-core scan's bf16 y may lie from the
    plain version's bf16 y ``want``: each is the bf16 rounding of a float32
    y (at most 2^-8 of it away) and the two float32 ys lie within 2e-4 of
    each other, so |got - want| <= 2^-7 |want| / (1 - 2^-8) + (1 + 2^-8)
    2e-4."""
    return 2.0 ** -7 / (1 - 2.0 ** -8) * want.float().abs() \
        + (1 + 2.0 ** -8) * 2e-4


def assert_ssd_matches_plain(args, chunk, got):
    """The scan's (y, S) against the plain version on the same inputs: S
    within 2e-4; y within 2e-4 in float32 and 2e-2 in bf16 on the CUDA
    cores. A bf16 y on the tensor cores: element by element within
    ``bf16_ssd_bound`` of the plain version's bf16 y, and within 2e-2
    wherever |y| < 4 (further out a sum in another order rounds to the
    neighbouring bf16 value now and then, one step of 2^-5 or more). The
    bf16 instance is the float32 instance on the same values plus one
    rounding of y, so its y must also be that rounding bit for bit, and
    the float32 y within 2e-4 of the plain version's float32 y."""
    x = args[0]
    B, L, H, P = x.shape
    want = ssm_scan.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-4)
    tc = ssm_scan.tensor_core_route(min(chunk, L), args[3].shape[-1], P)
    if x.dtype == torch.float32 or not tc:
        torch.testing.assert_close(
            got[0].float(), want[0].float(), rtol=0,
            atol=2e-4 if x.dtype == torch.float32 else 2e-2)
        return
    diff = (got[0].float() - want[0].float()).abs()
    assert float((diff / bf16_ssd_bound(want[0])).max()) <= 1.0
    near = want[0].float().abs() < 4
    assert float(torch.where(near, diff, 0.0).max()) <= 2e-2
    wide = (x.float(),) + tuple(args[1:])
    got32 = ssm_scan.ssm_scan(*wide, chunk=chunk)[0]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got32.to(torch.bfloat16))
    torch.testing.assert_close(
        got32, ssm_scan.ssd_scan_plain(*wide, chunk=chunk)[0], rtol=0,
        atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk,route", SSD_ROUTE_CASES)
def test_ssm_scan_routes_by_shape_on_card(B, L, H, P, N, chunk, route, dtype):
    """The shape picks the route (tensor cores for Q, N, P on the mma
    grain), one launch on that route's count, and both routes equal the
    plain version within the SSD tolerances."""
    needs_card()
    assert ssm_scan.tensor_core_route(min(chunk, L), N, P) == (
        route == "ssd_scan_tc")
    args = ssd_card_inputs(B, L, H, P, N, dtype, L + H + P + N)
    before = dict(ssm_scan.LAUNCHES)
    got = ssm_scan.ssm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ssm_scan.LAUNCHES.items()} == {
        k: int(k == route) for k in before}
    assert_ssd_matches_plain(args, chunk, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,P,N", [(40, 32, 16), (33, 32, 16),
                                       (37, 16, 8)])
def test_ssm_scan_reads_strided_x_on_both_routes_on_card(width, P, N, dtype):
    """x as a view into a wider row, as the model passes it: a row stride
    of 40 elements keeps 16-byte rows (the tensor-core kernel reads it in
    place), 33 does not (the wrapper copies first); N = 8 takes the
    CUDA-core route. All equal the contiguous input's result."""
    needs_card()
    B, L, H = 2, 128, 2
    x, dt, A, Bm, Cm = ssd_card_inputs(B, L, H, P, N, dtype, width)
    wide = torch.zeros((B, L, H * width), dtype=dtype, device="cuda")
    wide.view(B, L, H, width)[..., :P] = x
    view = wide.view(B, L, H, width)[..., :P]
    assert not view.is_contiguous()
    got = ssm_scan.ssm_scan(view, dt, A, Bm, Cm, chunk=64)
    want = ssm_scan.ssm_scan(x.contiguous(), dt, A, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert_ssd_matches_plain((x, dt, A, Bm, Cm), 64, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M", [
    (3, 1001, 3), (7, 13, 5), (150, 2000, 4), (100, 998, 8), (263, 1003, 4),
    (264, 1002, 8), (300, 999, 1), (5, 1000, 9), (270, 1002, 20),
])
def test_map_decide_split_and_slots_match_plain_on_card(B, N, M):
    """map_decide bit for bit on both sides of the cluster split (rows
    below and from 2 x 132), N % 4 != 0 (tasks before and after the
    16-byte groups), M on both sides of 8 (register slots or shared
    atomics), with every kind."""
    needs_card()
    t = {k: torch.as_tensor(v, device="cuda")
         for k, v in kernel_inputs(B, N, M, 4, seed=N).items()}
    md = (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
          t["deadline"], t["pending"], t["task_type"])
    for nom, key, drop in ALL_KINDS:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        got = map_fused.map_decide(*md, t["suffered"], **kw)
        torch.cuda.synchronize()
        want = map_fused.map_decide_plain(*md, t["suffered"], **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (B, N, M, kw)


@pytest.mark.cuda
def test_map_decide_reads_unaligned_task_arrays_on_card():
    """Task arrays that start off a 16-byte boundary (views one task in)
    go one task at a time and still equal the plain version."""
    needs_card()
    B, N, M = 6, 500, 4
    x = kernel_inputs(B, N + 1, M, 4, seed=3)
    t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    # Each task array as a contiguous (B, N) view one element into its
    # flat storage.
    shifted = {k: t[k].reshape(-1)[1:1 + B * N].view(B, N)
               for k in ("deadline", "pending", "task_type", "suffered")}
    assert shifted["deadline"].data_ptr() % 16 != 0
    md = (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
          shifted["deadline"], shifted["pending"], shifted["task_type"])
    for nom, key, drop in ALL_KINDS[::5]:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        got = map_fused.map_decide(*md, shifted["suffered"], **kw)
        torch.cuda.synchronize()
        want = map_fused.map_decide_plain(*md, shifted["suffered"], **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float16])
def test_ssm_scan_exact_bc_is_the_general_route_bit_for_bit_on_card(
        bc_dtype, dtype):
    """B and C in bfloat16 or float16 (as the model passes them) are exact
    in TF32: the tensor-core kernel then leaves out the products of their
    zero lo parts, which changes no bit of y or S against the same values
    passed as float32."""
    needs_card()
    x, dt, A, Bm, Cm = ssd_card_inputs(2, 256, 4, 64, 64, dtype, 17)
    Bh, Ch = Bm.to(bc_dtype), Cm.to(bc_dtype)
    got = ssm_scan.ssm_scan(x, dt, A, Bh, Ch, chunk=128)
    want = ssm_scan.ssm_scan(x, dt, A, Bh.float(), Ch.float(), chunk=128)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert_ssd_matches_plain((x, dt, A, Bh, Ch), 128, got)


@pytest.mark.cuda
@pytest.mark.parametrize("system,dispatcher", [("paper", None),
                                               ("paper_x2", "fair_spill")])
def test_observed_fused_run_matches_observed_plain_run_on_card(system,
                                                               dispatcher):
    """The observers on the kernel path equal the observers on the plain
    path on the card, every aux leaf bit for bit (float32 times and
    energies included), with a finite energy budget halting some
    replicates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch import scenarios
    from repro_torch.core import engine, observe

    spec = scenarios.get_fleet(system).build()
    F = spec.n_sites
    traces = scenarios.DEFAULT.stack(0, (2.0 * F, 6.0 * F), 3, 300, spec.eet,
                                     device="cuda")
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    m = engine.simulate_batch(flat, spec, "FELARE", dispatcher=dispatcher,
                              device="cuda")
    cap = float((m.energy_dynamic + m.energy_idle).mean()) * 0.5
    observers = ("task_log", "fairness_trajectory",
                 observe.Timeline(per_site=True),
                 observe.EnergyBudget(capacity=cap))
    runs = [engine.simulate_batch(flat, spec, "FELARE", observers=observers,
                                  dispatcher=dispatcher, use_fused_map=fused,
                                  device="cuda") for fused in (True, False)]
    (mk, aux_k), (mp, aux_p) = runs
    for a, b in zip(mk, mp):
        assert torch.equal(a, b)
    assert set(aux_k) == set(aux_p)
    for name in aux_k:
        for leaf in aux_k[name]:
            assert torch.equal(aux_k[name][leaf], aux_p[name][leaf]), \
                (system, name, leaf)
    assert bool(aux_k["energy_budget"]["exhausted"].any())


@pytest.mark.cuda
@pytest.mark.parametrize("system,heuristic,dispatcher,dynamics,fused", [
    ("paper_x2", "backup1", "health_aware", "churn", "map"),
    ("paper_x2", "FELARE", "fair_spill", "outage", "map"),
    ("paper", "ELARE", None, "degrade", "phase1"),
])
def test_faulted_fused_run_matches_faulted_plain_run_on_card(
        system, heuristic, dispatcher, dynamics, fused):
    """Under machine faults the kernel path equals the plain path on the
    card, every Metrics field and aux leaf bit for bit (task_log with its
    retries, the health series): paper_x2 under churn with
    ``with_backup(FELARE, 1)`` and under a site outage, and flat ELARE on
    ``phase1_map`` with a straggler at 2.0 x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch import scenarios
    from repro_torch.core import engine, faults

    dyn = {"churn": faults.BernoulliUpDown(p_fail=0.02, p_recover=0.2),
           "outage": faults.SiteOutage(outages=((0, 0.25, 0.5),)),
           "degrade": faults.Degrade(factor=2.0, machines=(1,))}[dynamics]
    pol = (faults.with_backup("FELARE", 1) if heuristic == "backup1"
           else heuristic)
    spec = scenarios.get_fleet(system).build()
    F = spec.n_sites
    traces = scenarios.DEFAULT.stack(0, (2.0 * F, 6.0 * F), 3, 300, spec.eet,
                                     device="cuda")
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    mf.LAUNCHES.update({k: 0 for k in mf.LAUNCHES})
    phase1_map.LAUNCHES["phase1_map"] = 0
    runs = [engine.simulate_batch(
        flat, spec, pol, observers=("task_log", "health"),
        dispatcher=dispatcher, dynamics=dyn, device="cuda",
        use_fused_map=kernel and fused == "map",
        use_fused_phase1=kernel and fused == "phase1")
        for kernel in (True, False)]
    launched = (phase1_map.LAUNCHES["phase1_map"] if fused == "phase1"
                else mf.LAUNCHES["map_decide"])
    assert launched > 0
    (mk, aux_k), (mp, aux_p) = runs
    for a, b, f in zip(mk, mp, mk._fields):
        assert torch.equal(a, b), f
    for name in aux_k:
        for leaf in aux_k[name]:
            assert torch.equal(aux_k[name][leaf], aux_p[name][leaf]), \
                (system, name, leaf)
    if dynamics != "degrade":
        assert int(aux_k["task_log"]["retries"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("heuristic,dispatcher", [("FELARE", "fair_spill"),
                                                  ("ELARE", "tier_aware")])
def test_networked_fused_run_matches_networked_plain_run_on_card(
        heuristic, dispatcher):
    """Under the default ``tiered`` network on tiered_x4 (masked fold,
    in-transit tasks hidden from the map kernels) the kernel path equals
    the plain path on the card, every Metrics field and aux leaf bit for
    bit (task_log with its ready times, the network series)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch import scenarios
    from repro_torch.core import engine

    spec = scenarios.get_fleet("tiered_x4").build()
    traces = scenarios.DEFAULT.stack(0, (6.0, 12.0), 3, 300, spec.eet,
                                     device="cuda")
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    mf.LAUNCHES.update({k: 0 for k in mf.LAUNCHES})
    runs = [engine.simulate_batch(
        flat, spec, heuristic, observers=("task_log", "network"),
        dispatcher=dispatcher, network="tiered", device="cuda",
        use_fused_map=fused) for fused in (True, False)]
    assert mf.LAUNCHES["map_decide"] > 0
    (mk, aux_k), (mp, aux_p) = runs
    for a, b, f in zip(mk, mp, mk._fields):
        assert torch.equal(a, b), f
    for name in aux_k:
        for leaf in aux_k[name]:
            assert torch.equal(aux_k[name][leaf], aux_p[name][leaf]), \
                (dispatcher, name, leaf)
    if dispatcher == "fair_spill":  # hash homes: links are paid
        assert bool((aux_k["task_log"]["ready_time"] > flat.arrival).any())


# --------------------------------------------------------------------------
# The shapes of the synthetic fleets: cvb and wide-fleet (8 types on 6
# machines), range (6 on 6), mixed_sites (7 machines in sites of 4 and 3,
# the masked fold), federated-skew (paper_x2 under a skewed mix).
# --------------------------------------------------------------------------
MIXED_SITES = (0, 0, 0, 0, 1, 1, 1)


def assert_map_kernels_match_plain(t, what):
    """map_decide over every nominator x key x drop rule with the suffered
    split on and off, evict_stats, and phase1_map over the gathered rows,
    each bit for bit with its plain version."""
    md = (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
          t["deadline"], t["pending"], t["task_type"])
    for nom, key, drop in ALL_KINDS:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        for suffered in (t["suffered"], torch.zeros_like(t["suffered"])):
            got = map_fused.map_decide(*md, suffered, **kw)
            torch.cuda.synchronize()
            want = map_fused.map_decide_plain(*md, suffered, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (what, kw)
    es = (t["start"], t["qfree"], t["eet"], t["deadline"], t["pending"],
          t["task_type"])
    for g, w in zip(map_fused.evict_stats(*es),
                    map_fused.evict_stats_plain(*es)):
        assert torch.equal(g, w), what
    from repro_torch.core.eet import type_rows

    p1 = (t["start"], type_rows(t["eet"], t["task_type"].long()).contiguous(),
          t["deadline"], t["p_dyn"], t["pending"], t["qfree"])
    for g, w in zip(phase1_map.phase1_map(*p1),
                    phase1_map.phase1_map_plain(*p1)):
        assert torch.equal(g, w), what


@pytest.mark.cuda
@pytest.mark.parametrize("S,M", [(8, 6), (6, 6)], ids=["cvb", "range"])
def test_map_kernels_at_synthetic_fleet_shapes_on_card(S, M):
    """The map kernels at S x M = 8 x 6 and 6 x 6 (map_decide's instance
    for up to 8 machines with the columns past M masked), on the sweep's
    150 x 2000 rows."""
    needs_card()
    x = kernel_inputs(150, 2000, M, S, seed=S)
    t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    assert_map_kernels_match_plain(t, (S, M))


@pytest.mark.cuda
def test_map_kernels_on_the_mixed_sites_fold_on_card():
    """The masked fold of mixed_sites: a row per (replicate, site) holding
    all 7 machines, the other site's EET columns at BIG (4 of them for
    site 1, 3 for site 0)."""
    needs_card()
    from repro_torch.core.equations import BIG

    B, N, S = 150, 2000, 4
    sites = np.asarray(MIXED_SITES)
    x = kernel_inputs(2 * B, N, sites.size, S, seed=7)
    r = np.random.default_rng(7)
    eet = np.round(r.uniform(0.5, 5.0, (2, S, sites.size)) * 8) / 8
    eet = np.where(sites[None, None, :] == np.arange(2)[:, None, None],
                   eet, BIG)
    x["eet"] = np.tile(eet, (B, 1, 1)).astype(np.float32)
    t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    assert_map_kernels_match_plain(t, "mixed_sites")


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.01, 0.5, 1.0])
def test_balance_scan_over_unequal_sites_on_card(density):
    """The balance walk over two sites of 4 and 3 machines (queue 2: loads
    up to 12 and 9), with and without a dead site, at the sweep's shape."""
    needs_card()
    r = np.random.default_rng(int(100 * density))
    B, N = 150, 2000
    load0 = np.stack([r.integers(0, 13, B), r.integers(0, 10, B)], 1)
    load0[: B // 4, 1] += 1_000_000
    args = [torch.as_tensor(a, device="cuda") for a in (
        load0.astype(np.int64), r.random((B, N)) < density,
        r.random((B, N)) < 0.5, r.integers(0, 2, (B, N)).astype(np.int64))]
    got = map_fused.balance_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, map_fused.balance_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("scenario,system,heuristic,dispatcher", [
    ("wide-fleet", None, "FELARE", None),
    ("wide-fleet", None, "ELARE", None),
    ("heavy-tail", "range", "FELARE", None),
    ("flash-crowd", "mixed_sites", "FELARE", "least_queued"),
    ("flash-crowd", "mixed_sites", "FELARE", "min_eet"),
    ("federated-skew", None, "FELARE", "sticky_by_type"),
    ("federated-skew", None, "FELARE", "fair_spill"),
])
def test_scenario_fleet_fused_run_matches_plain_run_on_card(
        scenario, system, heuristic, dispatcher):
    """A scenario sweep on its fleet through the kernels equals the plain
    path on the card, every Metrics field bit for bit, and launched every
    kernel of its path."""
    needs_card()
    from repro_torch import scenarios
    from repro_torch.core import dispatch, engine

    scn = scenarios.get(scenario)
    spec = (scenarios.get_fleet(system) if system else scn.fleet).build()
    traces = scn.stack(0, (2.0, 4.0 * spec.n_sites), 3, 300, spec.eet,
                       device="cuda")
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    disp = (dispatch.Sticky(by_type=True) if dispatcher == "sticky_by_type"
            else dispatcher)
    mf.LAUNCHES.update({k: 0 for k in mf.LAUNCHES})
    phase1_map.LAUNCHES["phase1_map"] = 0
    fused = engine.simulate_batch(flat, spec, heuristic, dispatcher=disp,
                                  use_fused_map=heuristic == "FELARE",
                                  use_fused_phase1=heuristic == "ELARE",
                                  device="cuda")
    if heuristic == "ELARE":
        assert phase1_map.LAUNCHES["phase1_map"] > 0
    else:
        assert mf.LAUNCHES["map_decide"] > 0
        assert mf.LAUNCHES["evict_stats"] > 0
    if dispatcher in ("least_queued", "fair_spill"):
        assert mf.LAUNCHES["balance_scan"] > 0
    plain = engine.simulate_batch(flat, spec, heuristic, dispatcher=disp,
                                  device="cuda")
    for a, b, f in zip(fused, plain, fused._fields):
        assert torch.equal(a, b), (scenario, f)


# --------------------------------------------------------------------------
# The dense GQA serve shapes (hd 128) and the router's shapes (B = 1)
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [2, 3, 8])
def test_dense_gqa_attention_at_hd_128_on_card(g, dtype):
    """Flash and decode attention with g query heads per kv head at head
    dim 128, the dense configs' (internlm2-1.8b g = 2, phi4-mini-3.8b
    g = 3, command-r-35b g = 8; 8 kv heads), against their plain
    versions: decode at g = 3 runs the kernel's 4-head instance with one
    head masked."""
    needs_card()
    Hkv, hd, S = 8, 128, 192
    H = g * Hkv
    q = card_normal((2, S, H, hd), g, dtype)
    k = card_normal((2, S, Hkv, hd), g + 1, dtype)
    v = card_normal((2, S, Hkv, hd), g + 2, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert_attention_close(got, flash_plain(causal=True), q, k, v)
    Sk = 1088
    q1 = card_normal((3, 1, H, hd), g + 3, dtype)
    ck = card_normal((3, Sk, Hkv, hd), g + 4, dtype)
    cv = card_normal((3, Sk, Hkv, hd), g + 5, dtype)
    kv_len = torch.tensor([Sk, 1, 1056], dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q1, ck, cv, kv_len)
    assert_attention_close(got, decode_plain(kv_len), q1, ck, cv)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 7, 17])
def test_map_kernels_at_batch_one_on_card(N):
    """The router's calls: one event (B = 1) of N tasks, N changing from
    call to call; every output bit for bit with the plain version."""
    needs_card()
    t = {k: torch.as_tensor(v, device="cuda")
         for k, v in kernel_inputs(1, N, 4, 4, seed=N).items()}
    md = (t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
          t["deadline"], t["pending"], t["task_type"])
    for nom, key, drop in ALL_KINDS:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        got = map_fused.map_decide(*md, t["suffered"], **kw)
        want = map_fused.map_decide_plain(*md, t["suffered"], **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (N, kw)
    es = (t["start"], t["qfree"], t["eet"], t["deadline"], t["pending"],
          t["task_type"])
    for g, w in zip(map_fused.evict_stats(*es),
                    map_fused.evict_stats_plain(*es)):
        assert torch.equal(g, w), N
    p1 = (t["start"], t["eet"][t["task_type"].long()].contiguous(),
          t["deadline"], t["p_dyn"], t["pending"], t["qfree"])
    for g, w in zip(phase1_map.phase1_map(*p1),
                    phase1_map.phase1_map_plain(*p1)):
        assert torch.equal(g, w), N


@pytest.mark.cuda
def test_router_fused_stream_matches_plain_on_card():
    """The serving launcher's stream (120 requests, rate 1000) routed by
    FELARE through the kernels on the card: every ``metrics()`` field
    equal to plain FELARE's on the card and on the CPU, and one
    ``evict_stats`` and one ``map_decide`` launch per policy call."""
    needs_card()
    from repro_torch.core import policy
    from repro_torch.launch import serve

    name = "FELARE_FUSED_MAP_CARD_TEST"
    policy.register(name, policy.with_fused_map("FELARE"), overwrite=True)
    try:
        runs = {}
        for label, heuristic, device in (("fused", name, "cuda"),
                                         ("plain", "FELARE", "cuda"),
                                         ("cpu", "FELARE", "cpu")):
            mf.LAUNCHES.update({k: 0 for k in mf.LAUNCHES})
            args = serve.parse_args(["--requests", "120", "--rate", "1000",
                                     "--heuristic", heuristic,
                                     "--device", device])
            router = serve.run(args)
            runs[label] = (router.metrics(), router.map_calls,
                           dict(mf.LAUNCHES))
    finally:
        policy.unregister(name)
    want = runs["cpu"][0]
    for label in ("fused", "plain"):
        got = runs[label][0]
        for k, v in want.items():
            assert np.array_equal(np.asarray(got[k]), np.asarray(v)), \
                (label, k)
    calls, launches = runs["fused"][1], runs["fused"][2]
    assert calls > 0
    assert launches["map_decide"] == launches["evict_stats"] == calls
    assert runs["plain"][2]["map_decide"] == 0


# --------------------------------------------------------------------------
# The serve shapes of the moe, vlm and audio families
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd", [(24, 8, 64), (14, 2, 64), (32, 8, 128),
                                      (16, 16, 64)])
def test_family_gqa_attention_on_card(H, Hkv, hd, dtype):
    """Flash (causal) and decode attention at the new families' head
    layouts: granite-moe-3b g = 3 and internvl2-1b g = 7 at head dim 64
    (decode on the kernel's 4- and 8-head instances with heads masked),
    phi3.5-moe g = 4 at 128, whisper-medium g = 1 at 64."""
    needs_card()
    S, g = 160, H // Hkv
    q = card_normal((2, S, H, hd), g, dtype)
    k = card_normal((2, S, Hkv, hd), g + 1, dtype)
    v = card_normal((2, S, Hkv, hd), g + 2, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert_attention_close(got, flash_plain(causal=True), q, k, v)
    Sk = 1344
    q1 = card_normal((3, 1, H, hd), g + 3, dtype)
    ck = card_normal((3, Sk, Hkv, hd), g + 4, dtype)
    cv = card_normal((3, Sk, Hkv, hd), g + 5, dtype)
    kv_len = torch.tensor([Sk, 1, 1300], dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q1, ck, cv, kv_len)
    assert_attention_close(got, decode_plain(kv_len), q1, ck, cv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_encoder_and_cross_attention_on_card(dtype):
    """whisper-medium's attention: the encoder's non-causal 1500 x 1500
    (one batch row), the cross-attention of a 4-token decoder prompt over
    1500 frames, and decode over a 1500-row cross cache, all 16 heads of
    64 without GQA."""
    needs_card()
    H, hd, Se = 16, 64, 1500
    q = card_normal((1, Se, H, hd), 1, dtype)
    k = card_normal((1, Se, H, hd), 2, dtype)
    v = card_normal((1, Se, H, hd), 3, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=False)
    assert_attention_close(got, flash_plain(causal=False), q, k, v)
    q4 = card_normal((2, 4, H, hd), 4, dtype)
    k2 = card_normal((2, Se, H, hd), 5, dtype)
    v2 = card_normal((2, Se, H, hd), 6, dtype)
    got = flash_attention.flash_attention(q4, k2, v2, causal=False)
    assert_attention_close(got, flash_plain(causal=False), q4, k2, v2)
    q1 = q4[:, :1].contiguous()
    xlen = torch.full((2,), Se, dtype=torch.int32, device="cuda")
    got = decode_attention.decode_attention(q1, k2, v2, xlen)
    assert_attention_close(got, decode_plain(xlen), q1, k2, v2)
