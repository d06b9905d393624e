"""The model kernels' plain versions against the JAX package's kernels.

Flash attention, decode attention and the SSD scan of the port run on CPU
tensors, where each wrapper takes its plain version; the same numpy-seeded
inputs go through the JAX ``ops.*(..., interpret=True)`` (the Pallas kernel
in interpret mode) and its ``ref.py`` oracle. Shapes and tolerances are
``tests/test_kernels.py``'s (attention 1e-5 in float32 and 2e-2 in
bfloat16, SSD 2e-4: sums run in another order), with head dim 80 (the
serve path's) added, and the TPU kernels' masked-row semantics checked.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jdec
from repro.kernels.decode_attention import ref as jdec_ref
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.flash_attention import ref as jflash_ref
from repro.kernels.ssm_scan import ops as jssm
from repro.models import ssm as jssm_model
from repro_torch.kernels import decode_attention, flash_attention, ssm_scan
from repro_torch.models import layers as tll
from repro_torch.models import ssm as tssm

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16,
                       2e-2)}


def normal(r, shape, dtype=np.float32, scale=0.5):
    """Seeded normal numbers, rounded to ``dtype`` once, so that the JAX
    and the port's inputs are the same bits."""
    return (r.standard_normal(shape) * scale).astype(np.float32).astype(dtype)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def bhsd(x):
    return jnp.moveaxis(jnp.asarray(x), 2, 1)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd", [
    (128, 128, 4, 4, 64),      # MHA
    (128, 128, 4, 2, 64),      # GQA
    (256, 256, 8, 1, 32),      # MQA
    (64, 192, 4, 2, 128),      # uneven
    (128, 128, 4, 2, 80),      # the serve path's head dim
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_jax(Sq, Sk, H, Hkv, hd, dtype):
    np_dt, jnp_dt, _, tol = DTYPES[dtype]
    r = np.random.default_rng(Sq + Sk + H + hd)
    B = 2
    q = normal(r, (B, Sq, H, hd), np_dt)
    k = normal(r, (B, Sk, Hkv, hd), np_dt)
    v = normal(r, (B, Sk, Hkv, hd), np_dt)
    causal = Sq == Sk
    got = flash_attention.flash_attention(to_torch(q), to_torch(k),
                                          to_torch(v), causal=causal)
    assert got.dtype == to_torch(q).dtype and got.shape == (B, Sq, H, hd)
    pallas = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, bq=64,
                                    bk=64, interpret=True)
    ref = jnp.moveaxis(jflash_ref.flash_attention_ref(
        bhsd(q), bhsd(k), bhsd(v), causal=causal), 1, 2)
    np.testing.assert_allclose(f32(got), f32(pallas), atol=tol)
    np.testing.assert_allclose(f32(got), f32(ref), atol=tol)


@pytest.mark.parametrize("hd", [32, 80])
def test_flash_attention_kv_len_and_offset(hd):
    r = np.random.default_rng(9)
    B, S, H = 2, 128, 2
    q = normal(r, (B, 32, H, hd))
    k = normal(r, (B, S, H, hd))
    v = normal(r, (B, S, H, hd))
    kv_len = np.array([100, 57], np.int32)
    got = flash_attention.flash_attention(
        to_torch(q), to_torch(k), to_torch(v), causal=True,
        kv_len=to_torch(kv_len), q_offset=64)
    pallas = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_len=jnp.asarray(kv_len), q_offset=64, bq=32, bk=64,
        interpret=True)
    ref = jnp.moveaxis(jflash_ref.flash_attention_ref(
        bhsd(q), bhsd(k), bhsd(v), jnp.asarray(kv_len), causal=True,
        q_offset=64), 1, 2)
    np.testing.assert_allclose(f32(got), f32(pallas), atol=1e-5)
    np.testing.assert_allclose(f32(got), f32(ref), atol=1e-5)


def test_masked_rows_follow_the_tpu_kernels():
    """A row with no valid key: the TPU kernels' finite -1e30 and
    max(l, 1e-30) give the mean of V over the keys (Sk a multiple of the
    block, so the TPU wrapper pads nothing); the port's kernels do the
    same, while the XLA counterpart (``sdpa_plain``) gives NaN there."""
    r = np.random.default_rng(3)
    B, Sk, H, hd = 2, 128, 2, 80
    q = normal(r, (B, 1, H, hd))
    k = normal(r, (B, Sk, H, hd))
    v = normal(r, (B, Sk, H, hd))
    kv_len = np.array([0, 77], np.int32)
    tq, tk, tv, tl = map(to_torch, (q, k, v, kv_len))
    mean_v = v.mean(axis=1)[:, None]                     # (B, 1, H, hd)

    dec = decode_attention.decode_attention(tq, tk, tv, tl)
    pallas = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kv_len),
                                   bk=64, interpret=True)
    np.testing.assert_allclose(f32(dec), f32(pallas), atol=1e-5)
    np.testing.assert_allclose(f32(dec)[0], mean_v[0], atol=1e-5)

    qs = normal(r, (B, 64, H, hd))
    flash = flash_attention.flash_attention(to_torch(qs), tk, tv,
                                            causal=False, kv_len=tl)
    fpallas = jflash.flash_attention(jnp.asarray(qs), jnp.asarray(k),
                                     jnp.asarray(v), causal=False,
                                     kv_len=jnp.asarray(kv_len), bq=64,
                                     bk=64, interpret=True)
    np.testing.assert_allclose(f32(flash), f32(fpallas), atol=1e-5)
    np.testing.assert_allclose(f32(flash)[0],
                               np.broadcast_to(mean_v[0], (64, H, hd)),
                               atol=1e-5)

    xla = tll.sdpa_plain(tq, tk, tv, causal=False, kv_len=tl)
    assert torch.isnan(xla[0]).all() and torch.isfinite(xla[1]).all()
    np.testing.assert_allclose(f32(xla)[1], f32(dec)[1], atol=1e-5)


# --------------------------------------------------------------------------
# decode attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("Sk,H,Hkv,hd", [
    (256, 4, 4, 64), (512, 8, 2, 64), (1024, 4, 1, 128), (192, 2, 2, 32),
    (320, 4, 4, 80),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_jax(Sk, H, Hkv, hd, dtype):
    np_dt, _, _, tol = DTYPES[dtype]
    r = np.random.default_rng(Sk + H)
    B = 2
    q = normal(r, (B, 1, H, hd), np_dt)
    k = normal(r, (B, Sk, Hkv, hd), np_dt)
    v = normal(r, (B, Sk, Hkv, hd), np_dt)
    kv_len = r.integers(1, Sk, B).astype(np.int32)
    got = decode_attention.decode_attention(*map(to_torch, (q, k, v, kv_len)))
    pallas = jdec.decode_attention(*map(jnp.asarray, (q, k, v, kv_len)),
                                   bk=128, interpret=True)
    ref = jnp.moveaxis(jdec_ref.decode_attention_ref(
        bhsd(q), bhsd(k), bhsd(v), jnp.asarray(kv_len)), 1, 2)
    np.testing.assert_allclose(f32(got), f32(pallas), atol=tol)
    np.testing.assert_allclose(f32(got), f32(ref), atol=tol)


# --------------------------------------------------------------------------
# SSD scan
# --------------------------------------------------------------------------
def ssd_inputs(L, H, P, N, seed):
    """``test_kernels.py``'s distributions: x, B, C ~ 0.5 N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(0.3 N(0, 1))."""
    r = np.random.default_rng(seed)
    B = 2
    x = normal(r, (B, L, H, P))
    dt = np.logaddexp(r.standard_normal((B, L, H)), 0).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.3)).astype(np.float32)
    return x, dt, A, normal(r, (B, L, N)), normal(r, (B, L, N))


@pytest.mark.parametrize("L,H,P,N,chunk", [
    (64, 2, 32, 16, 16), (128, 4, 64, 64, 32), (96, 1, 16, 8, 32),
    (256, 2, 64, 32, 128),
])
def test_ssm_scan_matches_jax(L, H, P, N, chunk):
    args = ssd_inputs(L, H, P, N, L + H + P)
    y, S = ssm_scan.ssm_scan(*map(to_torch, args), chunk=chunk)
    jy, jS = jssm.ssm_scan(*map(jnp.asarray, args), chunk=chunk,
                           interpret=True)
    ry, rS = jssm_model.ssd_ref(*map(jnp.asarray, args))
    for want_y, want_S in ((jy, jS), (ry, rS)):
        np.testing.assert_allclose(f32(y), f32(want_y), atol=2e-4)
        np.testing.assert_allclose(f32(S), f32(want_S), atol=2e-4)


@pytest.mark.parametrize("L,chunk", [(128, 32), (48, 128)])
def test_ssd_plain_paths_match_jax(L, chunk):
    """The port's ``ssd_chunked`` (the plain model path) and ``ssd_ref``
    against the reference's, and against the kernel's plain version."""
    args = ssd_inputs(L, 2, 32, 16, 77)
    jy, jS = jssm_model.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, tS = tssm.ssd_chunked(*map(to_torch, args), chunk)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=2e-4)
    np.testing.assert_allclose(f32(tS), f32(jS), atol=2e-4)
    ry, rS = tssm.ssd_ref(*map(to_torch, args))
    jry, jrS = jssm_model.ssd_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(f32(ry), f32(jry), atol=2e-4)
    np.testing.assert_allclose(f32(rS), f32(jrS), atol=2e-4)
    ky, kS = ssm_scan.ssd_scan_plain(*map(to_torch, args), chunk=chunk)
    np.testing.assert_allclose(f32(ky), f32(ty), atol=2e-4)
    np.testing.assert_allclose(f32(kS), f32(tS), atol=2e-4)


def test_ssm_scan_reads_a_strided_x():
    """The model hands the scan a view into the conv output; the result
    is the contiguous input's, and bf16 x gives bf16 y."""
    x, dt, A, Bm, Cm = map(to_torch, ssd_inputs(64, 2, 16, 8, 5))
    wide = torch.cat([x.reshape(2, 64, 32), torch.ones(2, 64, 8)], dim=-1)
    view = wide[..., :32].reshape(2, 64, 2, 16)
    assert not view.is_contiguous()
    for a, b in zip(ssm_scan.ssm_scan(view, dt, A, Bm, Cm, chunk=16),
                    ssm_scan.ssm_scan(x, dt, A, Bm, Cm, chunk=16)):
        assert torch.equal(a, b)
    y, S = ssm_scan.ssm_scan(x.bfloat16(), dt, A, Bm, Cm, chunk=16)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32


# --------------------------------------------------------------------------
# wrappers on the CPU
# --------------------------------------------------------------------------
def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    r = np.random.default_rng(1)
    q, k, v = (to_torch(normal(r, s)) for s in
               ((2, 16, 4, 80), (2, 16, 2, 80), (2, 16, 2, 80)))
    kv_len = torch.tensor([16, 9], dtype=torch.int32)
    before = (dict(flash_attention.LAUNCHES), dict(decode_attention.LAUNCHES),
              dict(ssm_scan.LAUNCHES))
    assert torch.equal(
        flash_attention.flash_attention(q, k, v, causal=True, q_offset=3),
        flash_attention.flash_attention_plain(q, k, v, causal=True,
                                              q_offset=3))
    assert torch.equal(
        decode_attention.decode_attention(q[:, :1], k, v, kv_len),
        decode_attention.decode_attention_plain(q[:, :1], k, v, kv_len))
    args = tuple(map(to_torch, ssd_inputs(32, 2, 16, 8, 2)))
    for a, b in zip(ssm_scan.ssm_scan(*args, chunk=16),
                    ssm_scan.ssd_scan_plain(*args, chunk=16)):
        assert torch.equal(a, b)
    assert before == (flash_attention.LAUNCHES, decode_attention.LAUNCHES,
                      ssm_scan.LAUNCHES)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(torch.zeros(1, 4, 2, 272),
                                        torch.zeros(1, 4, 2, 272),
                                        torch.zeros(1, 4, 2, 272))
    with pytest.raises(TypeError, match="share"):
        flash_attention.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention.flash_attention(q, torch.zeros(1, 4, 3, 16),
                                        torch.zeros(1, 4, 3, 16))
    with pytest.raises(ValueError, match="decode takes"):
        decode_attention.decode_attention(q, q, q, torch.ones(1))
    x, dt, A, Bm, Cm = map(to_torch, ssd_inputs(48, 2, 16, 8, 0))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm_scan.ssm_scan(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="dt has shape"):
        ssm_scan.ssm_scan(x, dt[:, :, :1], A, Bm, Cm, chunk=16)
