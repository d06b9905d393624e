"""Cross-attention and the chunked plain attention of the port
(``repro_torch/models/layers.py``) against the JAX package's on the CPU,
float32, on the same numpy inputs.

``sdpa_plain_chunked`` against ``sdpa_xla_chunked`` with a query length
off the block, causal with a ``q_offset``, and ``kv_len``;
``attn_apply`` with a K/V source of another length (q roped with the
decoder's positions, k with the encoder's) and ``attn_decode(cross=True)``
(the encoder's cache read at ``xlen`` rows and never written), both
against the reference's, and ``attn_init``'s K/V source width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jll
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tll
from repro_torch.models import transformer as ttf
from test_torch_families import port_tensor

F32 = dict(dtype="float32", param_dtype="float32")


def close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-3 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("Sq,Sk,causal,q_offset,ragged", [
    (100, 100, True, 0, False),     # Sq off the block of 32
    (40, 72, True, 32, False),      # causal with a q_offset
    (50, 64, False, 0, True),       # kv_len
    (1, 64, False, 0, True),        # one query row (decode)
])
def test_sdpa_plain_chunked_matches_sdpa_xla_chunked(Sq, Sk, causal,
                                                     q_offset, ragged):
    rng = np.random.default_rng(Sq + Sk)
    B, H, Hkv, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array([Sk, Sk // 2 + 3], np.int32) if ragged else None
    want = jll.sdpa_xla_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        q_offset=q_offset, block=32)
    got = tll.sdpa_plain_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_len=None if kv_len is None else torch.from_numpy(kv_len),
        q_offset=q_offset, block=32)
    assert got.shape == (B, Sq, H, hd)
    close(got, want, "chunked")
    plain = tll.sdpa_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_len=None if kv_len is None else torch.from_numpy(kv_len),
        q_offset=q_offset)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)


def attn_params(arch, seed, d_kv_src=None):
    jcfg = jreg.get_smoke_config(arch).scaled(**F32, attn_impl="xla")
    jp = jll.attn_init(jax.random.PRNGKey(seed), jcfg, d_kv_src)
    tp = {k: port_tensor(v) for k, v in jp.items()}
    return jcfg, jp, tp


def test_attn_init_takes_a_kv_source_width():
    cfg = treg.get_smoke_config("whisper-medium")
    spec = tll.attn_init(cfg, d_kv_src=40)
    _, jp, _ = attn_params("whisper-medium", 0, d_kv_src=40)
    for key in jp:
        assert spec[key].shape == jp[key].shape, key
    assert spec["wk"].shape == (40, cfg.n_kv_heads * cfg.hd)


@pytest.mark.parametrize("impl", ["kernel", "plain", "plain_chunked"])
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_cross_attention_matches_jax(arch, impl):
    """Full-sequence cross-attention over an encoder of 24 rows, then
    one decode step against that encoder's K/V as the cache (12 of its
    rows valid for the second request)."""
    jcfg, jp, tp = attn_params(arch, 1)
    tcfg = treg.get_smoke_config(arch).scaled(**F32, attn_impl=impl)
    rng = np.random.default_rng(5)
    B, Sd, Se, d = 2, 6, 24, jcfg.d_model
    x = rng.standard_normal((B, Sd, d)).astype(np.float32)
    enc = rng.standard_normal((B, Se, d)).astype(np.float32)
    dpos, epos = np.arange(Sd), np.arange(Se)
    want, (wk, wv) = jll.attn_apply(
        jcfg, jp, jnp.asarray(x), jnp.asarray(dpos), causal=False,
        kv_src=jnp.asarray(enc), kv_positions=jnp.asarray(epos))
    got, (gk, gv) = tll.attn_apply(
        tcfg, tp, torch.from_numpy(x), torch.from_numpy(dpos), causal=False,
        kv_src=torch.from_numpy(enc), kv_positions=torch.from_numpy(epos))
    close(got, want, "cross attn_apply")
    close(gk, wk, "cross k (roped with the encoder's positions)")
    close(gv, wv, "cross v")

    xlen = np.array([Se, 12], np.int32)
    pos = np.array([[Sd], [Sd + 3]])
    xd = rng.standard_normal((B, 1, d)).astype(np.float32)
    want, wck, _, wlen = jll.attn_decode(
        jcfg, jp, jnp.asarray(xd), jnp.asarray(pos), wk, wv,
        jnp.asarray(xlen), cross=True)
    ck, cv = gk.clone(), gv.clone()
    got, ck2, cv2, glen = tll.attn_decode(
        tcfg, tp, torch.from_numpy(xd), torch.from_numpy(pos), ck, cv,
        torch.from_numpy(xlen), cross=True)
    close(got, want, "cross attn_decode")
    assert glen.tolist() == np.asarray(wlen).tolist() == xlen.tolist()
    assert ck2 is ck and torch.equal(ck, gk) and torch.equal(cv, gv)


def test_no_rope_leaves_q_and_k_unrotated():
    """use_rope=False: the same as rope at position 0 everywhere."""
    jcfg, jp, tp = attn_params("qwen1.5-0.5b", 2)
    tcfg = treg.get_smoke_config("qwen1.5-0.5b").scaled(**F32)
    x = np.random.default_rng(6).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    want, _ = jll.attn_apply(jcfg, jp, jnp.asarray(x), jnp.arange(8),
                             use_rope=False)
    got, _ = tll.attn_apply(tcfg, tp, torch.from_numpy(x), torch.arange(8),
                            use_rope=False)
    close(got, want, "no rope")
    zero, _ = tll.attn_apply(tcfg, tp, torch.from_numpy(x),
                             torch.zeros(8, dtype=torch.long))
    torch.testing.assert_close(got, zero)


def test_audio_decode_reads_the_cross_cache_and_never_writes_it():
    cfg = treg.get_smoke_config("whisper-medium").scaled(**F32)
    params = ttf.init(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 5))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, 20, cfg.d_model)).astype(np.float32))}
    _, cache = ttf.prefill(cfg, params, batch, max_seq=24)
    xk, xv = cache["xk"].clone(), cache["xv"].clone()
    assert torch.equal(xk[:, :, 20:], torch.zeros_like(xk[:, :, 20:]))
    logits, cache = ttf.decode_step(cfg, params, cache,
                                    torch.tensor([[3], [4]]))
    assert torch.equal(cache["xk"], xk) and torch.equal(cache["xv"], xv)
    assert cache["len"].tolist() == [6, 6]
    assert cache["xlen"].tolist() == [20, 20]
    assert torch.isfinite(logits).all()
