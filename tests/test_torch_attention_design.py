"""The arithmetic of the port's attention kernels, emulated in PyTorch on the
CPU and held against the JAX package's kernels (Pallas in interpret mode).

The CUDA kernels run only on the card; what their design changes in the
arithmetic is emulated here step for step, so that it is checked where the
JAX reference runs:

- decode attention splits the cache over the 8 blocks of a cluster: each
  block's chunk of ceil(Sk / 8) keys rounded up to 8 gives a partial (m, l,
  acc), -inf / 0 / 0 for a chunk wholly past the keys to read, -1e30
  scores for every key when kv_len <= 0, and the partials are merged in
  split order. Held in float32 within atol 1e-5.
- flash attention in bf16 feeds the unscaled bf16 q and k to the tensor
  cores (float32 sums), scales the float32 score, keeps l from the float32
  p and rounds p to bf16 for P.V, tile by tile of 64 keys. Held within the
  bf16 tolerance of 2e-2, and the rounding of p alone within 2^-8 max|v|;
  against the plain version also element by element, within the bound that
  ``chip_smoke.py`` and the card's tests hold the kernel to, with q and k
  spread as in tests/test_kernels.py and five times wider.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_bhd
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels import decode_attention, flash_attention
from test_torch_kernels_cuda import bf16_attention_bound

NEG_INF = -1e30
NSPLIT = 8
KEY_TILE = 64


def normal(r, shape, dtype=np.float32, scale=0.5):
    return (r.standard_normal(shape) * scale).astype(np.float32).astype(dtype)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bhsd(x):
    return jnp.moveaxis(jnp.asarray(x), 2, 1)


# --------------------------------------------------------------------------
# decode attention: split over a cluster, merged in split order
# --------------------------------------------------------------------------
def split_chunk(Sk: int) -> int:
    """Keys per block: ceil(Sk / 8) rounded up to a multiple of 8."""
    per = -(-Sk // NSPLIT)
    return -(-per // 8) * 8


def decode_split_emulation(q, k, v, kv_len):
    """The decode kernel's arithmetic in float32: q (B, 1, H, hd), k and v
    (B, Sk, Hkv, hd), kv_len (B,). Returns (B, 1, H, hd) float32."""
    B, _, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    chunk = split_chunk(Sk)
    qf = q.float().reshape(B, Hkv, g, hd) * (hd ** -0.5)
    kf = k.float().permute(0, 2, 1, 3)                    # (B, Hkv, Sk, hd)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty(B, Hkv, g, hd)
    for b in range(B):
        kvl = int(kv_len[b])
        kend = min(kvl, Sk) if kvl >= 1 else Sk
        parts = []
        for split in range(NSPLIT):
            lo, hi = split * chunk, min((split + 1) * chunk, kend)
            if lo >= hi:                                  # empty partial
                parts.append((torch.full((Hkv, g), -torch.inf),
                              torch.zeros(Hkv, g), torch.zeros(Hkv, g, hd)))
                continue
            s = torch.einsum("kgd,ksd->kgs", qf[b], kf[b, :, lo:hi])
            if kvl < 1:
                s = torch.full_like(s, NEG_INF)           # every key masked
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgs,ksd->kgd", p, vf[b, :, lo:hi])))
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        L = torch.zeros(Hkv, g)
        A = torch.zeros(Hkv, g, hd)
        for m, l, acc in parts:                           # split order
            w = torch.where(m == -torch.inf, torch.zeros(()),
                            torch.exp(m - M))
            L = L + w * l
            A = A + w[..., None] * acc
        out[b] = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, hd)


def kv_len_case(kind: str, Sk: int) -> int:
    c = split_chunk(Sk)
    return {"zero": 0, "one": 1, "boundary": c, "boundary+1": c + 1,
            "full": Sk}[kind]


def jax_key_block(Sk: int) -> int:
    """A key block that divides Sk, so that the TPU kernel pads nothing
    (its padded keys would score -1e30 and join the all-masked mean)."""
    return max(d for d in range(1, min(Sk, 256) + 1) if Sk % d == 0)


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("kind", ["zero", "one", "boundary", "boundary+1",
                                  "full"])
@pytest.mark.parametrize("Sk", [8, 192, 1088, 1089])
def test_decode_split_combine_matches_jax(Sk, kind, g):
    r = np.random.default_rng(Sk * 7 + g)
    B, Hkv, hd = 2, 2, 80
    H = g * Hkv
    q = normal(r, (B, 1, H, hd))
    k = normal(r, (B, Sk, Hkv, hd))
    v = normal(r, (B, Sk, Hkv, hd))
    kv_len = np.array([kv_len_case(kind, Sk), Sk // 2 + 1], np.int32)
    tq, tk, tv, tl = map(to_torch, (q, k, v, kv_len))
    got = decode_split_emulation(tq, tk, tv, tl)
    pallas = jnp.moveaxis(decode_attention_bhd(
        bhsd(q), bhsd(k), bhsd(v), jnp.asarray(kv_len),
        bk=jax_key_block(Sk), interpret=True), 1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    plain = decode_attention.decode_attention_plain(tq, tk, tv, tl)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    if kind == "zero":                                    # the mean of V
        np.testing.assert_allclose(got[0, 0].numpy(),
                                   np.repeat(v[0].mean(0), g, axis=0),
                                   atol=1e-5)


def test_split_chunks_cover_the_cache():
    """Eight chunks of ceil(Sk / 8) keys rounded up to 8 cover every key
    once, and block 0's chunk always holds key 0."""
    for Sk in (1, 7, 8, 9, 192, 1088, 1089, 4096):
        c = split_chunk(Sk)
        assert c % 8 == 0 and -(-Sk // NSPLIT) <= c < -(-Sk // NSPLIT) + 8
        owners = [j // c for j in range(Sk)]
        assert owners[0] == 0 and max(owners) < NSPLIT


# --------------------------------------------------------------------------
# flash attention in bf16: the tensor-core numerics
# --------------------------------------------------------------------------
def flash_bf16_emulation(q, k, v, *, causal, kv_len, q_offset=0,
                         round_p=True):
    """The bf16 flash kernel's arithmetic: q (B, Sq, H, hd), k and v
    (B, Sk, Hkv, hd) bf16, kv_len (B,) or None. Returns float32."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, hd)             # exact: bf16 values
    kf, vf = k.float(), v.float()
    qpos = torch.arange(Sq)[:, None] + q_offset
    kl = torch.full((B,), Sk) if kv_len is None else kv_len.long()
    m = torch.full((B, Hkv, g, Sq), NEG_INF)
    l = torch.zeros(B, Hkv, g, Sq)
    acc = torch.zeros(B, Hkv, g, Sq, hd)
    for k0 in range(0, Sk, KEY_TILE):
        kt = slice(k0, min(k0 + KEY_TILE, Sk))
        # unscaled bf16 products summed in float32, then scaled
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, kt]) * (hd ** -0.5)
        kpos = torch.arange(k0, kt.stop)[None, :]
        valid = (kpos[None] < kl[:, None, None])           # (B, 1, n)
        if causal:
            valid = valid & (qpos >= kpos)[None]
        s = torch.where(valid[:, None, None], s, torch.full((), NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)                          # float32 p
        pv = p.bfloat16().float() if round_p else p
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", pv,
                                                    vf[:, kt])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("kv", ["ragged", "zero"])
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd", [
    (128, 128, 4, 4, 64),      # MHA
    (128, 128, 4, 2, 64),      # GQA
    (256, 256, 8, 1, 32),      # MQA
    (64, 192, 4, 2, 128),      # uneven
    (128, 128, 4, 2, 80),      # the serve path's head dim
])
def test_flash_bf16_numerics_match_jax(Sq, Sk, H, Hkv, hd, kv):
    bf = ml_dtypes.bfloat16
    r = np.random.default_rng(Sq + Sk + H + hd + len(kv))
    B = 2
    q = normal(r, (B, Sq, H, hd), bf)
    k = normal(r, (B, Sk, Hkv, hd), bf)
    v = normal(r, (B, Sk, Hkv, hd), bf)
    kv_len = np.array([Sk - 37, Sk // 2 + 3] if kv == "ragged"
                      else [0, Sk // 2 + 3], np.int32)
    causal = Sq == Sk
    tq, tk, tv, tl = map(to_torch, (q, k, v, kv_len))
    got = flash_bf16_emulation(tq, tk, tv, causal=causal, kv_len=tl)
    out = got.bfloat16().float().numpy()                  # stored as bf16
    pallas = jnp.moveaxis(flash_attention_bhsd(
        bhsd(q), bhsd(k), bhsd(v), jnp.asarray(kv_len), causal=causal,
        bq=64, bk=64, interpret=True), 1, 2)
    np.testing.assert_allclose(out, np.asarray(pallas, np.float32),
                               atol=2e-2)
    plain = flash_attention.flash_attention_plain(tq, tk, tv, causal=causal,
                                                  kv_len=tl)
    np.testing.assert_allclose(out, plain.float().numpy(), atol=2e-2)
    # Rounding p to bf16 moves an output by at most 2^-8 max|v|.
    exact = flash_bf16_emulation(tq, tk, tv, causal=causal, kv_len=tl,
                                 round_p=False)
    assert float((got - exact).abs().max()) <= 2.0 ** -8 * float(
        tv.float().abs().max())
    if kv == "zero":                                      # the mean of V
        mean_v = v[0].astype(np.float32).mean(0)           # (Hkv, hd)
        want = np.repeat(mean_v, H // Hkv, axis=0)        # (H, hd)
        np.testing.assert_allclose(got[0].numpy(),
                                   np.broadcast_to(want, (Sq, H, hd)),
                                   atol=1e-5)



@pytest.mark.parametrize("qk_scale", [0.5, 2.5])
@pytest.mark.parametrize("kv", ["ragged", "zero"])
@pytest.mark.parametrize("Sq,Sk,H,Hkv,hd", [
    (128, 128, 4, 2, 64),
    (256, 256, 8, 1, 32),
    (64, 192, 4, 2, 128),
    (128, 200, 4, 2, 80),
])
def test_flash_bf16_numerics_within_per_element_bound(Sq, Sk, H, Hkv, hd,
                                                      kv, qk_scale):
    bf = ml_dtypes.bfloat16
    r = np.random.default_rng(Sq + Sk + H + hd + len(kv) + int(qk_scale))
    B = 2
    q = to_torch(normal(r, (B, Sq, H, hd), bf, qk_scale))
    k = to_torch(normal(r, (B, Sk, Hkv, hd), bf, qk_scale))
    v = to_torch(normal(r, (B, Sk, Hkv, hd), bf))
    kv_len = torch.tensor([Sk - 37, Sk // 2 + 3] if kv == "ragged"
                          else [0, Sk // 2 + 3], dtype=torch.int32)
    kw = dict(causal=Sq <= Sk, kv_len=kv_len, q_offset=Sk - Sq)

    def plain(q, k, v):
        return flash_attention.flash_attention_plain(q, k, v, **kw)

    got = flash_bf16_emulation(q, k, v, **kw).bfloat16().float()
    want = plain(q, k, v).float()
    bound = bf16_attention_bound(plain, q, k, v)
    assert float(((got - want).abs() / bound).max()) <= 1.0
    # the bound is tight enough to see one tile of 64 keys dropped
    short = dict(kw, kv_len=(kv_len - 64).clamp_min(1))
    dropped = flash_bf16_emulation(q, k, v, **short).bfloat16().float()
    keep = (kv_len > 64)[:, None, None, None] & (
        torch.arange(Sq)[:, None, None] + Sk - Sq >= 64)
    assert bool((((dropped - want).abs() > bound) & keep).any())
