"""Mixture-of-Experts layer: top-k token-choice routing with per-group
capacity dispatch.

Counterpart of ``repro/models/moe.py``. Tokens are split into groups of at
most ``cfg.moe_group`` (the largest divisor of the token count not above
it), and each group dispatches into its own per-expert buffers of
``_capacity`` slots. A (token, k) pair's slot is its rank among the pairs
routed to the same expert, counted in token-major (token, k) order; a pair
past the capacity overflows, and its token keeps only the residual path
for that expert. At decode the group is the batch's B tokens, so the
capacity is small and tokens drop that a full-sequence forward keeps: that
is the reference's semantics.

Numerics follow the reference: the router's product and softmax run in
float32, the gate product ``g`` stays float32 into SiLU, and ``u``, the
SiLU-gated hidden and the down product are rounded to the activation
dtype. The expert products are plain large products, taken with
``torch.bmm`` as the reference takes them with XLA.

Under :func:`rows_shared` (a sharded step whose batch rows are split over
data-parallel ranks) each layer routes the whole batch's tokens, as the
reference's step over the whole batch does: the groups, the capacities
and the load-balancing loss are the whole batch's, and each rank keeps
its own rows of the output.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init


def moe_init(cfg: ModelConfig):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _dense_init((d, E), torch.float32),
        "w_gate": _dense_init((E, d, ff), cfg.p_dtype),
        "w_up": _dense_init((E, d, ff), cfg.p_dtype),
        "w_down": _dense_init((E, ff, d), cfg.p_dtype),
    }


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(c, cfg.experts_per_token)


def _group_size(T: int, cfg: ModelConfig) -> int:
    """The largest divisor of T not above ``cfg.moe_group``."""
    Tg = min(cfg.moe_group, T)
    while T % Tg:
        Tg -= 1
    return Tg


def top_k(probs, k: int):
    """The k largest values along the last dim and their indices, equal
    values in order of their index (``lax.top_k``'s order): a stable sort,
    since ``torch.topk`` promises no order among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bmm(a, w):
    """``a @ w`` per expert, rounded to a's dtype (float32 accumulation)."""
    if a.dtype == w.dtype:
        return torch.bmm(a, w)
    return torch.bmm(a.float(), w.float()).to(a.dtype)


#: ``None``, or the ``(gather, own)`` pair that :func:`rows_shared` sets.
_SHARED_ROWS = None


@contextlib.contextmanager
def rows_shared(gather, own):
    """Route every MoE layer's tokens as one batch with the other ranks':
    ``gather(x)`` gives the whole batch's rows (on every rank, its
    backward summing over them), ``own(y)`` this rank's rows of the
    whole batch's output."""
    global _SHARED_ROWS
    prev, _SHARED_ROWS = _SHARED_ROWS, (gather, own)
    try:
        yield
    finally:
        _SHARED_ROWS = prev


def moe_apply(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> ((B, S, d), aux): the load-balancing loss, float32
    (under :func:`rows_shared`, the whole batch's)."""
    if _SHARED_ROWS is not None:
        gather, own = _SHARED_ROWS
        y, aux = _route(cfg, p, gather(x))
        return own(y), aux
    return _route(cfg, p, x)


def _route(cfg: ModelConfig, p, x):
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    Tg = _group_size(T, cfg)
    G = T // Tg
    C = _capacity(Tg, cfg)
    dt = x.dtype
    xt = x.reshape(G, Tg, d)

    logits = torch.einsum("gtd,de->gte", xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                  # (G, Tg, E)
    gate_vals, gate_idx = top_k(probs, K)                  # (G, Tg, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot of each (token, k): its rank among the pairs routed to the same
    # expert, in token-major order; the one-hot is laid out (G, E, Tg K)
    # so that the count runs along its innermost dim
    flat_idx = gate_idx.reshape(G, 1, Tg * K)
    hit = flat_idx == torch.arange(E, device=x.device)[None, :, None]
    ranks = torch.cumsum(hit, dim=-1)                      # (G, E, Tg K)
    pos = ranks.gather(1, flat_idx).reshape(G, Tg, K) - 1
    within = pos < C
    pos_c = torch.where(within, pos, C)                    # C: overflow bin

    # scatter into the (G, E, C + 1, d) buffers; every slot below C is
    # written by exactly one pair, so no sum and no order matters there
    gidx = torch.arange(G, device=x.device)[:, None, None].expand(G, Tg, K)
    xe = torch.zeros((G, E, C + 1, d), dtype=dt, device=x.device)
    xe.index_put_((gidx, gate_idx, pos_c),
                  xt[:, :, None, :].expand(G, Tg, K, d))
    xe3 = xe[:, :, :C].transpose(0, 1).reshape(E, G * C, d)

    # expert products in the (E, G * C, d) layout; g in float32
    g = torch.bmm(xe3.float(), p["w_gate"].float())
    u = _bmm(xe3, p["w_up"])
    h = F.silu(g).to(dt) * u
    ye3 = _bmm(h, p["w_down"])
    ye = ye3.reshape(E, G, C, d).transpose(0, 1)           # (G, E, C, d)

    # gather combine: y[t] = sum_k gate[t, k] ye[e_k, slot_k]
    back = ye[gidx, gate_idx, pos_c.clamp(max=C - 1)]      # (G, Tg, K, d)
    y = (back * (gate_vals.to(dt) * within.to(dt))[..., None]).sum(2)

    # Switch-style load-balancing loss
    me = probs.reshape(T, E).mean(0)
    ce = hit.reshape(G, E, Tg, K).any(-1).float().mean((0, 2))
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux
