"""Model stack: ``init`` / ``forward`` / ``init_cache`` / ``prefill`` /
``decode_step``, dispatching on ``cfg.family``.

Counterpart of ``repro/models/transformer.py`` for two families:

  dense   : pre-norm GQA transformer
  hybrid  : Zamba2 — Mamba2 backbone + one shared attention block invoked
            every ``attn_every`` layers (per-invocation norms)

The others (moe, ssm, audio, vlm) raise ``NotImplementedError`` until
they are ported (ROADMAP A6b). Parameters are nested dicts of tensors with
the reference's keys, per-layer leaves stacked on a leading (L, ...) axis;
the layer loops are Python loops over that axis. ``forward`` and
``prefill`` return final hidden states; the LM head is applied by the
caller (``repro_torch.train.steps``) or by ``decode_step``.

Decode updates the cache in place (KV rows, SSM and conv states) and
returns it with ``len`` advanced; the reference returns new arrays.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Leaf

FAMILIES = ("dense", "hybrid")


def _check_family(cfg: ModelConfig) -> str:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A6b); the "
            f"port runs {FAMILIES}")
    return cfg.family


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict (a Leaf or a tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked (L, ...) leaves."""
    return tree_map(lambda a: a[i], tree)


# ==========================================================================
# init
# ==========================================================================
def _attn_block_init(cfg):
    return {"ln1": ll.norm_init(cfg), "attn": ll.attn_init(cfg),
            "ln2": ll.norm_init(cfg), "mlp": ll.mlp_init(cfg)}


def _stacked(n: int, spec):
    """Stack a per-layer spec over ``n`` layers; the scale stays the one
    of the per-layer shape (fan_in is not the stacked axis)."""
    return tree_map(lambda lf: lf._replace(shape=(n,) + lf.shape), spec)


def param_spec(cfg: ModelConfig):
    """The parameter tree as :class:`Leaf` specs: shapes, dtypes and the
    reference's init distributions, nothing allocated."""
    fam = _check_family(cfg)
    params = {"embed": ll.embed_init(cfg), "final_norm": ll.norm_init(cfg)}
    if fam == "dense":
        params["blocks"] = _stacked(cfg.n_layers, _attn_block_init(cfg))
    else:
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"attn_every {cfg.attn_every}")
        n_inv = cfg.n_layers // cfg.attn_every
        params["blocks"] = _stacked(cfg.n_layers, {
            "ln": ll.norm_init(cfg), "mamba": ssm_mod.mamba_init(cfg)})
        params["shared_attn"] = _attn_block_init(cfg)
        params["inv_norms"] = Leaf((n_inv, cfg.d_model), cfg.p_dtype, "ones")
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
        w = torch.empty(lf.shape, dtype=torch.float32, device=dev)
        return w.normal_(generator=gen).mul_(lf.scale).to(lf.dtype)

    return tree_map(fill, param_spec(cfg))


# ==========================================================================
# full-sequence forward (prefill body)
# ==========================================================================
def _attn_block_apply(cfg, p, x, positions):
    """Pre-norm attention + MLP block. Returns (x, (k, v))."""
    h, kv = ll.attn_apply(cfg, p["attn"], ll.norm_apply(cfg, p["ln1"], x),
                          positions)
    x = x + h
    x = x + ll.mlp_apply(cfg, p["mlp"], ll.norm_apply(cfg, p["ln2"], x))
    return x, kv


def _embed_input(cfg, params, batch):
    """tokens -> (B, S, d), positions (S,)."""
    x = ll.embed_apply(params["embed"], batch["tokens"], cfg.act_dtype)
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


def forward(cfg: ModelConfig, params, batch):
    """-> (hidden (B, S, d), aux_loss). Causal LM over the full sequence."""
    fam = _check_family(cfg)
    x, positions = _embed_input(cfg, params, batch)
    if fam == "dense":
        for i in range(cfg.n_layers):
            x, _ = _attn_block_apply(cfg, _layer(params["blocks"], i), x,
                                     positions)
    else:
        for i in range(cfg.n_layers):
            x = _mamba_layer(cfg, _layer(params["blocks"], i), x)
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x, _ = _attn_block_apply(cfg, params["shared_attn"],
                                         _shared_input(cfg, params, x, g),
                                         positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ll.norm_apply(cfg, params["final_norm"], x), aux


# ==========================================================================
# KV / state caches
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero-initialized decode cache on ``device`` (``None`` = CUDA)."""
    fam = _check_family(cfg)
    dev = resolve_device(device)
    dt = cfg.act_dtype
    n_kv = cfg.n_layers if fam == "dense" else cfg.n_layers // cfg.attn_every
    kv_shape = (n_kv, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(kv_shape, dtype=dt, device=dev),
             "v": torch.zeros(kv_shape, dtype=dt, device=dev),
             "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if fam == "hybrid":
        L, N = cfg.n_layers, cfg.ssm_state
        cache["ssm"] = torch.zeros(
            (L, batch, cfg.ssm_heads, N, cfg.ssm_head_dim),
            dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (L, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), dtype=dt,
            device=dev)
    return cache


# ==========================================================================
# prefill
# ==========================================================================
def prefill(cfg: ModelConfig, params, batch, max_seq: int):
    """Process the prompt; return (last hidden (B, 1, d), cache) with the
    cache sized for ``max_seq`` positions. A hybrid prompt's length must
    be a multiple of ``min(ssm_chunk, S)``."""
    fam = _check_family(cfg)
    x, positions = _embed_input(cfg, params, batch)
    B, S = x.shape[:2]
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt {S}")
    cache = init_cache(cfg, B, max_seq, device=x.device)
    if fam == "dense":
        for i in range(cfg.n_layers):
            x, (k, v) = _attn_block_apply(cfg, _layer(params["blocks"], i), x,
                                          positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    else:
        for i in range(cfg.n_layers):
            x, stt = _mamba_layer(cfg, _layer(params["blocks"], i), x,
                                  return_state=True)
            cache["ssm"][i] = stt["ssm"]
            cache["conv"][i] = stt["conv"]
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x, (k, v) = _attn_block_apply(
                    cfg, params["shared_attn"],
                    _shared_input(cfg, params, x, g), positions)
                cache["k"][g, :, :S] = k
                cache["v"][g, :, :S] = v
    cache["len"].fill_(S)
    x = ll.norm_apply(cfg, params["final_norm"], x)
    return x[:, -1:], cache


# ==========================================================================
# decode
# ==========================================================================
def _attn_block_decode(cfg, p, x, pos, cache, g: int):
    h, _, _, _ = ll.attn_decode(cfg, p["attn"],
                                ll.norm_apply(cfg, p["ln1"], x), pos,
                                cache["k"][g], cache["v"][g], cache["len"])
    x = x + h
    return x + ll.mlp_apply(cfg, p["mlp"], ll.norm_apply(cfg, p["ln2"], x))


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step. tokens: (B, 1) -> (logits (B, 1, V) float32,
    cache). The cache's tensors are updated in place; the returned dict
    holds them and the advanced ``len``."""
    fam = _check_family(cfg)
    x = ll.embed_apply(params["embed"], tokens, cfg.act_dtype)
    pos = cache["len"][:, None]  # (B, 1) absolute position of the new token

    if fam == "dense":
        for i in range(cfg.n_layers):
            x = _attn_block_decode(cfg, _layer(params["blocks"], i), x, pos,
                                   cache, i)
    else:
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
