"""Model stack: ``init`` / ``forward`` / ``init_cache`` / ``prefill`` /
``decode_step``, dispatching on ``cfg.family``.

Counterpart of ``repro/models/transformer.py``, all six families:

  dense | vlm : pre-norm GQA transformer (a VLM prepends its stub patch
                embeddings to the tokens)
  moe         : GQA attention + top-k expert MLP
  ssm         : xLSTM, (mLSTM, sLSTM) superblocks
  hybrid      : Zamba2, a Mamba2 backbone + one shared attention block
                invoked every ``attn_every`` layers (per-invocation norms)
  audio       : Whisper backbone, a bidirectional encoder over stub frame
                embeddings + a causal decoder with cross-attention

Parameters are nested dicts of tensors with the reference's keys,
per-layer leaves stacked on a leading (L, ...) axis; the layer loops are
Python loops over that axis. ``forward`` and ``prefill`` return final
hidden states; the LM head is applied by the caller
(``repro_torch.train``) or by ``decode_step``.

``forward`` is the training body: it can be differentiated for every
family, and under ``cfg.remat`` each block's activations are recomputed
in the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per block) whenever autograd records. Serving is
unchanged by it.

Decode updates the cache in place (KV rows, SSM, conv and xLSTM states)
and returns it with ``len`` advanced; the reference returns new arrays.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import Leaf

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
ATTN_FAMILIES = ("dense", "vlm", "moe")    # one attention block per layer


def _check_family(cfg: ModelConfig) -> str:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port runs "
                         f"{FAMILIES}")
    return cfg.family


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict (a Leaf or a tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], tree)


def _layers(tree, n: int) -> list:
    """All ``n`` layers of a tree of stacked (L, ...) leaves, one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where ``n`` indexings would each add a full (L, ...) gradient."""
    per_leaf = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t, i=i: t[i], per_leaf) for i in range(n)]


def _remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat``, while autograd records, its
    activations are dropped and recomputed in the backward pass."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ==========================================================================
# init
# ==========================================================================
def _attn_block_init(cfg, cross=False):
    p = {"ln1": ll.norm_init(cfg), "attn": ll.attn_init(cfg),
         "ln2": ll.norm_init(cfg)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(cfg)
    else:
        p["mlp"] = ll.mlp_init(cfg)
    if cross:
        p["lnx"] = ll.norm_init(cfg)
        p["xattn"] = ll.attn_init(cfg)
    return p


def _stacked(n: int, spec):
    """Stack a per-layer spec over ``n`` layers; the scale stays the one
    of the per-layer shape (fan_in is not the stacked axis)."""
    return tree_map(lambda lf: lf._replace(shape=(n,) + lf.shape), spec)


def param_spec(cfg: ModelConfig):
    """The parameter tree as :class:`Leaf` specs: shapes, dtypes and the
    reference's init distributions, nothing allocated."""
    fam = _check_family(cfg)
    params = {"embed": ll.embed_init(cfg), "final_norm": ll.norm_init(cfg)}
    if fam in ATTN_FAMILIES:
        params["blocks"] = _stacked(cfg.n_layers, _attn_block_init(cfg))
    elif fam == "ssm":
        if cfg.n_layers % 2:
            raise ValueError(f"an xLSTM's n_layers {cfg.n_layers} must be "
                             f"even: (mLSTM, sLSTM) superblocks")
        params["blocks"] = _stacked(cfg.n_layers // 2, {
            "mlstm": xlstm_mod.mlstm_init(cfg),
            "slstm": xlstm_mod.slstm_init(cfg)})
    elif fam == "hybrid":
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"attn_every {cfg.attn_every}")
        n_inv = cfg.n_layers // cfg.attn_every
        params["blocks"] = _stacked(cfg.n_layers, {
            "ln": ll.norm_init(cfg), "mamba": ssm_mod.mamba_init(cfg)})
        params["shared_attn"] = _attn_block_init(cfg)
        params["inv_norms"] = Leaf((n_inv, cfg.d_model), cfg.p_dtype, "ones")
    else:  # audio
        params["enc_blocks"] = _stacked(cfg.encoder_layers,
                                        _attn_block_init(cfg))
        params["blocks"] = _stacked(cfg.n_layers,
                                    _attn_block_init(cfg, cross=True))
        params["enc_norm"] = ll.norm_init(cfg)
    return params


def param_shapes(cfg: ModelConfig):
    """The parameter tree as tensors on the ``meta`` device: the shapes
    and dtypes of :func:`init`'s, nothing allocated (the counterpart of
    the reference's ``jax.eval_shape`` of its init)."""
    return tree_map(
        lambda lf: torch.empty(lf.shape, dtype=lf.dtype, device="meta"),
        param_spec(cfg))


def init(cfg: ModelConfig, generator: torch.Generator | None = None, *,
         seed: int = 0, device=None):
    """Random parameters on ``device`` (``None`` = CUDA), drawn from
    ``generator`` (a new one seeded with ``seed`` if ``None``; it must
    live on ``device``): normal times the leaf's scale, drawn in float32
    and rounded to the leaf's dtype, as the reference's ``_dense_init``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)

    def fill(lf: Leaf):
        if lf.fill == "ones":
            return torch.ones(lf.shape, dtype=lf.dtype, device=dev)
        if lf.fill == "zeros":
            return torch.zeros(lf.shape, dtype=lf.dtype, device=dev)
        if lf.fill == "halves":  # last axis: zeros, then ``scale``
            w = torch.zeros(lf.shape, dtype=lf.dtype, device=dev)
            w[..., lf.shape[-1] // 2:] = lf.scale
            return w
        w = torch.empty(lf.shape, dtype=torch.float32, device=dev)
        return w.normal_(generator=gen).mul_(lf.scale).to(lf.dtype)

    return tree_map(fill, param_spec(cfg))


# ==========================================================================
# full-sequence forward (prefill body)
# ==========================================================================
def _attn_block_apply(cfg, p, x, positions, *, causal=True, enc=None,
                      enc_positions=None):
    """Pre-norm attention (+ cross-attention over ``enc``) + MLP or MoE
    block. Returns (x, (kv, xkv, aux)): the self-attention's (k, v), the
    cross-attention's (None without ``enc``) and the MoE's aux loss
    (None without experts)."""
    h, kv = ll.attn_apply(cfg, p["attn"], ll.norm_apply(cfg, p["ln1"], x),
                          positions, causal=causal)
    x = x + h
    xkv = None
    if enc is not None:
        h, xkv = ll.attn_apply(
            cfg, p["xattn"], ll.norm_apply(cfg, p["lnx"], x), positions,
            causal=False, kv_src=enc, kv_positions=enc_positions)
        x = x + h
    h, aux = _ffn(cfg, p, ll.norm_apply(cfg, p["ln2"], x))
    return x + h, (kv, xkv, aux)


def _ffn(cfg, p, x):
    """The block's MLP, or its experts: (out, aux or None)."""
    if cfg.family == "moe":
        return moe_mod.moe_apply(cfg, p["moe"], x)
    return ll.mlp_apply(cfg, p["mlp"], x), None


def _embed_input(cfg, params, batch):
    """tokens (+ a VLM's stub patch embeddings) -> (B, S, d), positions
    (S,)."""
    x = ll.embed_apply(params["embed"], batch["tokens"], cfg.act_dtype)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.device, cfg.act_dtype), x], 1)
    return x, torch.arange(x.shape[1], device=x.device)


def _mamba_layer(cfg, lp, x, *, return_state=False):
    out = ssm_mod.mamba_apply(cfg, lp["mamba"],
                              ll.norm_apply(cfg, lp["ln"], x),
                              return_state=return_state)
    if return_state:
        return x + out[0], out[1]
    return x + out


def _shared_input(cfg, params, x, g: int):
    """The shared block's input at invocation ``g``: x times its norm."""
    return x * params["inv_norms"][g][None, None].to(x.dtype)


def _encode(cfg, params, frames):
    """The audio encoder over stub frame embeddings: (enc, positions)."""
    x = frames.to(cfg.act_dtype)
    pos = torch.arange(x.shape[1], device=x.device)

    def block(x, lp):
        return _attn_block_apply(cfg, lp, x, pos, causal=False)[0]
    for lp in _layers(params["enc_blocks"], cfg.encoder_layers):
        x = _remat(cfg, block, x, lp)
    return ll.norm_apply(cfg, params["enc_norm"], x), pos


def forward(cfg: ModelConfig, params, batch):
    """-> (hidden (B, S, d), aux_loss). Causal LM over the full sequence
    (an audio model's decoder over its tokens, the encoder's frames
    attended)."""
    fam = _check_family(cfg)
    if fam == "audio":
        enc, enc_pos = _encode(cfg, params, batch["frames"])
        x = ll.embed_apply(params["embed"], batch["tokens"], cfg.act_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
    else:
        x, positions = _embed_input(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam in ATTN_FAMILIES:
        def block(x, lp):
            x, (_, _, a) = _attn_block_apply(cfg, lp, x, positions)
            return x, a
        for lp in _layers(params["blocks"], cfg.n_layers):
            x, a = _remat(cfg, block, x, lp)
            if a is not None:
                aux = aux + a
    elif fam == "ssm":
        def superblock(x, lp):
            x = xlstm_mod.mlstm_apply(cfg, lp["mlstm"], x)
            return xlstm_mod.slstm_apply(cfg, lp["slstm"], x)
        for lp in _layers(params["blocks"], cfg.n_layers // 2):
            x = _remat(cfg, superblock, x, lp)
    elif fam == "hybrid":
        def shared(x, p, g):
            return _attn_block_apply(cfg, p, _shared_input(cfg, params, x, g),
                                     positions)[0]
        for i, lp in enumerate(_layers(params["blocks"], cfg.n_layers)):
            x = _remat(cfg, partial(_mamba_layer, cfg), lp, x)
            if (i + 1) % cfg.attn_every == 0:
                x = _remat(cfg, shared, x, params["shared_attn"],
                           i // cfg.attn_every)
    else:  # audio
        def block(x, lp):
            return _attn_block_apply(cfg, lp, x, positions, enc=enc,
                                     enc_positions=enc_pos)[0]
        for lp in _layers(params["blocks"], cfg.n_layers):
            x = _remat(cfg, block, x, lp)
    return ll.norm_apply(cfg, params["final_norm"], x), aux


# ==========================================================================
# KV / state caches
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero-initialized decode cache on ``device`` (``None`` = CUDA). An
    audio model's cross cache holds ``max_seq`` encoder rows."""
    fam = _check_family(cfg)
    dev = resolve_device(device)
    dt, f32 = cfg.act_dtype, torch.float32
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if fam == "ssm":
        nsb, H, d = cfg.n_layers // 2, cfg.n_heads, cfg.d_model
        di, dh = 2 * d, d // H
        dk = di // H

        def zeros(*shape, dtype=f32):
            return torch.zeros((nsb, batch) + shape, dtype=dtype, device=dev)
        cache["mlstm"] = {"S": zeros(H, dk, dk), "n": zeros(H, dk),
                          "conv": zeros(3, di, dtype=dt)}
        cache["slstm"] = {"c": zeros(H, dh), "n": zeros(H, dh),
                          "h": zeros(H, dh),
                          "m": torch.full((nsb, batch, H, dh), -1e9,
                                          dtype=f32, device=dev)}
        return cache
    n_kv = cfg.n_layers // cfg.attn_every if fam == "hybrid" else \
        cfg.n_layers
    kv_shape = (n_kv, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    for key in ("k", "v") + (("xk", "xv") if fam == "audio" else ()):
        cache[key] = torch.zeros(kv_shape, dtype=dt, device=dev)
    if fam == "audio":
        cache["xlen"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if fam == "hybrid":
        L, N = cfg.n_layers, cfg.ssm_state
        cache["ssm"] = torch.zeros(
            (L, batch, cfg.ssm_heads, N, cfg.ssm_head_dim), dtype=f32,
            device=dev)
        cache["conv"] = torch.zeros(
            (L, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), dtype=dt,
            device=dev)
    return cache


# ==========================================================================
# prefill
# ==========================================================================
def _fits(what: str, n: int, max_seq: int) -> None:
    if max_seq < n:
        raise ValueError(f"max_seq {max_seq} is shorter than the {what} {n}")


def prefill(cfg: ModelConfig, params, batch, max_seq: int):
    """Process the prompt; return (last hidden (B, 1, d), cache) with the
    cache sized for ``max_seq`` positions. A hybrid prompt's length must
    be a multiple of ``min(ssm_chunk, S)``, an xLSTM's of ``min(128, S)``;
    an audio model's frames, padded into its cross cache, at most
    ``max_seq``."""
    fam = _check_family(cfg)
    if fam == "audio":
        return _prefill_audio(cfg, params, batch, max_seq)
    x, positions = _embed_input(cfg, params, batch)
    B, S = x.shape[:2]
    _fits("prompt", S, max_seq)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    if fam in ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            x, ((k, v), _, _) = _attn_block_apply(
                cfg, _layer(params["blocks"], i), x, positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    elif fam == "ssm":
        for i in range(cfg.n_layers // 2):
            lp = _layer(params["blocks"], i)
            x, mst = xlstm_mod.mlstm_apply(cfg, lp["mlstm"], x,
                                           return_state=True)
            x, sst = xlstm_mod.slstm_apply(cfg, lp["slstm"], x,
                                           return_state=True)
            for part, st in (("mlstm", mst), ("slstm", sst)):
                for key, val in st.items():
                    cache[part][key][i] = val
    else:  # hybrid
        for i in range(cfg.n_layers):
            x, stt = _mamba_layer(cfg, _layer(params["blocks"], i), x,
                                  return_state=True)
            cache["ssm"][i] = stt["ssm"]
            cache["conv"][i] = stt["conv"]
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x, ((k, v), _, _) = _attn_block_apply(
                    cfg, params["shared_attn"],
                    _shared_input(cfg, params, x, g), positions)
                cache["k"][g, :, :S] = k
                cache["v"][g, :, :S] = v
    cache["len"].fill_(S)
    x = ll.norm_apply(cfg, params["final_norm"], x)
    return x[:, -1:], cache


def _prefill_audio(cfg, params, batch, max_seq: int):
    """Encode the frames, run the decoder over its prompt tokens; the
    cache holds the decoder's K/V and every layer's cross K/V over the
    frames, both padded to ``max_seq`` rows."""
    enc, enc_pos = _encode(cfg, params, batch["frames"])
    x = ll.embed_apply(params["embed"], batch["tokens"], cfg.act_dtype)
    B, Sd = x.shape[:2]
    Se = enc.shape[1]
    _fits("decoder prompt", Sd, max_seq)
    _fits("encoder frames", Se, max_seq)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    dec_pos = torch.arange(Sd, device=x.device)
    for i in range(cfg.n_layers):
        x, ((k, v), (xk, xv), _) = _attn_block_apply(
            cfg, _layer(params["blocks"], i), x, dec_pos, enc=enc,
            enc_positions=enc_pos)
        cache["k"][i, :, :Sd] = k
        cache["v"][i, :, :Sd] = v
        cache["xk"][i, :, :Se] = xk
        cache["xv"][i, :, :Se] = xv
    cache["len"].fill_(Sd)
    cache["xlen"].fill_(Se)
    x = ll.norm_apply(cfg, params["final_norm"], x)
    return x[:, -1:], cache


# ==========================================================================
# decode
# ==========================================================================
def _attn_block_decode(cfg, p, x, pos, cache, g: int):
    """One token through attention block ``g``: self-attention on the
    cache (written in place), cross-attention on the encoder's cache
    (audio), then the MLP or the experts."""
    h, _, _, _ = ll.attn_decode(cfg, p["attn"],
                                ll.norm_apply(cfg, p["ln1"], x), pos,
                                cache["k"][g], cache["v"][g], cache["len"])
    x = x + h
    if "xattn" in p:
        h, _, _, _ = ll.attn_decode(cfg, p["xattn"],
                                    ll.norm_apply(cfg, p["lnx"], x), pos,
                                    cache["xk"][g], cache["xv"][g],
                                    cache["xlen"], cross=True)
        x = x + h
    return x + _ffn(cfg, p, ll.norm_apply(cfg, p["ln2"], x))[0]


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, 1, V) float32,
    cache). The cache's tensors are updated in place; the returned dict
    holds them and the advanced ``len``."""
    fam = _check_family(cfg)
    x = ll.embed_apply(params["embed"], tokens, cfg.act_dtype)
    pos = cache["len"][:, None]  # (B, 1) absolute position of the new token

    if fam in ATTN_FAMILIES or fam == "audio":
        for i in range(cfg.n_layers):
            x = _attn_block_decode(cfg, _layer(params["blocks"], i), x, pos,
                                   cache, i)
    elif fam == "ssm":
        for i in range(cfg.n_layers // 2):
            lp = _layer(params["blocks"], i)
            for part, step in (("mlstm", xlstm_mod.mlstm_decode),
                               ("slstm", xlstm_mod.slstm_decode)):
                x, st = step(cfg, lp[part], x, _layer(cache[part], i))
                for key, val in st.items():
                    cache[part][key][i] = val
    else:  # hybrid
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            out, stt = ssm_mod.mamba_decode(
                cfg, lp["mamba"], ll.norm_apply(cfg, lp["ln"], x),
                {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
            x = x + out
            cache["ssm"][i] = stt["ssm"]
            cache["conv"][i] = stt["conv"]
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x = _attn_block_decode(cfg, params["shared_attn"],
                                       _shared_input(cfg, params, x, g), pos,
                                       cache, g)
    cache = {**cache, "len": cache["len"] + 1}
    x = ll.norm_apply(cfg, params["final_norm"], x)
    return ll.unembed_apply(cfg, params["embed"], x), cache
