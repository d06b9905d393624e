"""Shared model layers: norms, RoPE, GQA attention, MLPs, embeddings.

Counterpart of ``repro/models/layers.py``. Layers are plain functions over
parameter dicts of tensors. The ``*_init`` functions return the parameters'
*specs* (:class:`Leaf`: shape, dtype and how to fill it, with the
reference's distributions); ``repro_torch.models.transformer.init`` fills
them from a ``torch.Generator`` on a device.

Numerics follow the reference: a projection multiplies in the activation
dtype and rounds its result to it (on the card a bf16 matmul accumulates in
float32, as ``preferred_element_type=float32`` does), norms, softmax, RoPE
and activations run in float32, and the LM head's logits are float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops


class Leaf(NamedTuple):
    """One parameter's spec: ``fill`` is ``"normal"`` (times ``scale``),
    ``"ones"`` or ``"zeros"``."""
    shape: tuple
    dtype: torch.dtype
    fill: str
    scale: float = 1.0


def _dense_init(shape, dtype, scale=None) -> Leaf:
    """The reference's ``_dense_init``: normal times ``fan_in ** -0.5``
    (``fan_in = shape[0]``) unless ``scale`` is given."""
    return Leaf(tuple(shape), dtype, "normal",
                scale if scale is not None else shape[0] ** -0.5)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def norm_init(cfg: ModelConfig, with_bias=None):
    with_bias = cfg.norm == "layernorm" if with_bias is None else with_bias
    p = {"scale": Leaf((cfg.d_model,), cfg.p_dtype, "ones")}
    if with_bias:
        p["bias"] = Leaf((cfg.d_model,), cfg.p_dtype, "zeros")
    return p


def norm_apply(cfg: ModelConfig, p, x):
    xf = x.float()
    if cfg.norm == "layernorm" and "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * p["scale"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S). Halves concatenated, not
    interleaved; float32 angles; the result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    base = torch.tensor(theta, dtype=torch.float32, device=x.device)
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA), pluggable impl
# --------------------------------------------------------------------------
def attn_init(cfg: ModelConfig, d_kv_src: int | None = None):
    """QKVO projections. ``d_kv_src`` != None: the width of a
    cross-attention's K/V source."""
    d, hd = cfg.d_model, cfg.hd
    dk = d_kv_src if d_kv_src is not None else d
    p = {
        "wq": _dense_init((d, cfg.n_heads * hd), cfg.p_dtype),
        "wk": _dense_init((dk, cfg.n_kv_heads * hd), cfg.p_dtype),
        "wv": _dense_init((dk, cfg.n_kv_heads * hd), cfg.p_dtype),
        "wo": _dense_init((cfg.n_heads * hd, d), cfg.p_dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((cfg.n_heads * hd,), cfg.p_dtype, "zeros")
        p["bk"] = Leaf((cfg.n_kv_heads * hd,), cfg.p_dtype, "zeros")
        p["bv"] = Leaf((cfg.n_kv_heads * hd,), cfg.p_dtype, "zeros")
    return p


def _proj(x, w, b=None):
    """``x @ w`` rounded to x's dtype (float32 accumulation), plus bias."""
    if x.dtype == w.dtype:
        y = torch.matmul(x, w)
    else:
        y = torch.matmul(x.float(), w.float())
    y = y.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def qkv(cfg: ModelConfig, p, x, kv_src=None):
    """Project to (B, S, H, hd) / (B, Skv, Hkv, hd); K and V from
    ``kv_src`` when given (cross-attention), else from x."""
    B = x.shape[0]
    kv_src = x if kv_src is None else kv_src
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, -1, cfg.n_heads, cfg.hd)
    k = _proj(kv_src, p["wk"], p.get("bk")).reshape(
        B, -1, cfg.n_kv_heads, cfg.hd)
    v = _proj(kv_src, p["wv"], p.get("bv")).reshape(
        B, -1, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def sdpa_plain(q, k, v, *, causal: bool, kv_len=None, q_offset=0):
    """Scaled-dot-product attention with GQA and a float32 softmax: the
    counterpart of the reference's ``sdpa_xla``, ``-inf`` masks included.

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd). ``kv_len``: (B,) valid KV
    prefix length (decode); ``q_offset``: absolute position of q[0] for the
    causal mask. The weights are rounded to v's dtype before the product
    with v, as there.
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    logits = logits * (hd ** -0.5)
    neg = torch.full((), -torch.inf, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(mask, logits, neg)
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < \
            kv_len.to(q.device)[:, None]                         # (B, Sk)
        logits = torch.where(valid[:, None, None, None], logits, neg)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def sdpa_plain_chunked(q, k, v, *, causal, kv_len=None, q_offset=0,
                       block: int = 1024):
    """Query-blockwise :func:`sdpa_plain` (the reference's
    ``sdpa_xla_chunked``): the same values, with the scores of at most
    ``block`` query rows alive at a time. q is padded with zero rows to a
    multiple of the block, and the padded rows are cut from the result."""
    B, Sq, H, hd = q.shape
    bs = min(block, Sq)
    pad = (-Sq) % bs
    qp = F.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
    outs = [sdpa_plain(qp[:, i:i + bs], k, v, causal=causal, kv_len=kv_len,
                       q_offset=q_offset + i)
            for i in range(0, qp.shape[1], bs)]
    return torch.cat(outs, dim=1)[:, :Sq]


def sdpa(cfg: ModelConfig, q, k, v, *, causal, kv_len=None, q_offset=0):
    """Implementation dispatch: ``plain`` | ``plain_chunked`` | ``kernel``
    (decode attention for one query row against a cache, flash attention
    otherwise)."""
    if cfg.attn_impl == "plain":
        return sdpa_plain(q, k, v, causal=causal, kv_len=kv_len,
                          q_offset=q_offset)
    if cfg.attn_impl == "plain_chunked":
        return sdpa_plain_chunked(q, k, v, causal=causal, kv_len=kv_len,
                                  q_offset=q_offset)
    if q.shape[1] == 1 and kv_len is not None:  # decode
        return dec_ops.decode_attention(q, k, v, kv_len)
    return flash_ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                     q_offset=q_offset)


def attn_apply(cfg: ModelConfig, p, x, positions, *, causal=True,
               kv_src=None, kv_positions=None, use_rope=True):
    """Full-sequence attention (prefill, encoder, cross). Returns (out,
    (k, v)). Cross-attention (``kv_src``) ropes q with ``positions`` and k
    with ``kv_positions``, as the reference does."""
    q, k, v = qkv(cfg, p, x, kv_src)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        kp = positions if kv_positions is None else kv_positions
        k = rope(k, kp, cfg.rope_theta)
    out = sdpa(cfg, q, k, v, causal=causal)
    B, S = x.shape[:2]
    return _proj(out.reshape(B, S, -1), p["wo"]), (k, v)


def _write_row(cache, idx, row):
    """``cache[b, idx[b]] = row[b]`` in place, where ``idx[b]`` is below the
    capacity; a write past it is a no-op (the reference's ``mode="drop"``).
    No host sync: past capacity the row's old value is written back."""
    B, S_max = cache.shape[:2]
    bidx = torch.arange(B, device=cache.device)
    ok = (idx < S_max)[:, None, None]
    at = idx.clamp(max=S_max - 1)
    cache.index_put_((bidx, at),
                     torch.where(ok, row.to(cache.dtype), cache[bidx, at]))


def attn_decode(cfg: ModelConfig, p, x, pos, ck, cv, cache_len, *,
                use_rope=True, cross=False):
    """Single-token decode against a KV cache.

    x: (B, 1, d); ck/cv: (B, S_max, Hkv, hd); cache_len: (B,) ints.
    Returns (out (B, 1, d), ck, cv, new_len). Unlike the reference, which
    returns new arrays, the new row is written into ``ck`` and ``cv`` in
    place (one (Hkv, hd) row per batch element); a write at or past
    ``S_max`` is a no-op, never a corruption and never an error.
    ``cross``: the cache is the encoder's K/V, read at ``cache_len`` rows
    and never written; only q is projected (and roped).
    """
    B = x.shape[0]
    if cross:
        q = _proj(x, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.hd)
        if use_rope:
            q = rope(q, pos, cfg.rope_theta)
        new_len = cache_len
    else:
        q, k1, v1 = qkv(cfg, p, x)
        if use_rope:
            q = rope(q, pos, cfg.rope_theta)
            k1 = rope(k1, pos, cfg.rope_theta)
        _write_row(ck, cache_len, k1[:, 0])
        _write_row(cv, cache_len, v1[:, 0])
        new_len = cache_len + 1
    out = sdpa(cfg, q, ck, cv, causal=False, kv_len=new_len)
    return _proj(out.reshape(B, 1, -1), p["wo"]), ck, cv, new_len


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_init(cfg: ModelConfig, d_ff=None):
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            "w_gate": _dense_init((d, ff), cfg.p_dtype),
            "w_up": _dense_init((d, ff), cfg.p_dtype),
            "w_down": _dense_init((ff, d), cfg.p_dtype),
        }
    return {
        "w_up": _dense_init((d, ff), cfg.p_dtype),
        "b_up": Leaf((ff,), cfg.p_dtype, "zeros"),
        "w_down": _dense_init((ff, d), cfg.p_dtype),
        "b_down": Leaf((d,), cfg.p_dtype, "zeros"),
    }


def mlp_apply(cfg: ModelConfig, p, x):
    if cfg.mlp == "swiglu":
        g = _proj(x, p["w_gate"])
        u = _proj(x, p["w_up"])
        return _proj(F.silu(g.float()).to(x.dtype) * u, p["w_down"])
    h = _proj(x, p["w_up"], p["b_up"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu
    return _proj(h, p["w_down"], p["b_down"])


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def embed_init(cfg: ModelConfig):
    """Token table over the padded vocab (rows past ``vocab_size`` are
    masked at the head); an untied LM head when the config says so."""
    V = cfg.padded_vocab
    p = {"tok": _dense_init((V, cfg.d_model), cfg.p_dtype,
                            scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init((cfg.d_model, V), cfg.p_dtype)
    return p


def embed_apply(p, tokens, dtype):
    return p["tok"][tokens].to(dtype)


def unembed_apply(cfg: ModelConfig, p, x):
    """Logits in float32: both operands upcast (exact for bf16), so the
    products and their sum are float32 as in the reference; padded-vocab
    columns read -1e30."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = torch.matmul(x.float(), w.float())
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
