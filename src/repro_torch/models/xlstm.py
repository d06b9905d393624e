"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory with a hidden-state recurrence, sequential over time).

Counterpart of ``repro/models/xlstm.py``. The mLSTM is the
sigmoid-input-gate gated-linear-attention variant, so its chunked form is
a handful of products per chunk (:func:`gla_chunked`, with the sequential
oracle :func:`gla_ref` beside it). The sLSTM's h_{t-1} feeds its gates, so
it runs one cell per token in a Python loop: the reference scans it with
``lax.scan`` and has no kernel for it. The blocks carry their own up and
down projections; there is no separate MLP.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Leaf, _dense_init, _proj, norm_apply
from repro_torch.models.layers import norm_init
from repro_torch.models.ssm import _causal_conv


# --------------------------------------------------------------------------
# chunked gated linear attention (mLSTM core)
# --------------------------------------------------------------------------
def gla_chunked(q, k, v, i_gate, logf, chunk: int):
    """S_t = f_t S_{t-1} + i_t k_t^T v_t;  n_t likewise with v = 1;
    y_t = (q_t S_t) / max(|q_t n_t|, 1).

    q, k: (B, L, H, Dk); v: (B, L, H, Dv); i_gate, logf: (B, L, H), logf
    <= 0. L must be a multiple of ``min(chunk, L)`` (nothing is padded).
    Returns y (B, L, H, Dv) in q's dtype and (S_final, n_final), float32.
    """
    B, L, H, Dk = q.shape
    Dv = v.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {Q}")
    nc = L // Q
    f32 = torch.float32

    qr = q.reshape(B, nc, Q, H, Dk).to(f32) * (Dk ** -0.5)
    kr = k.reshape(B, nc, Q, H, Dk).to(f32)
    vr = v.reshape(B, nc, Q, H, Dv).to(f32)
    ir = i_gate.reshape(B, nc, Q, H).to(f32)
    cl = torch.cumsum(logf.reshape(B, nc, Q, H).to(f32), dim=2)

    # decay_ij = exp(cl_i - cl_j) for j <= i, else 0; masked before the
    # exp, which above the diagonal (cl_i - cl_j >= 0) could overflow
    seg = cl[:, :, :, None, :] - cl[:, :, None, :, :]      # (B, nc, Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  torch.full((), -torch.inf,
                                             device=q.device)))
    qk = torch.einsum("bcihd,bcjhd->bchij", qr, kr)
    irj = ir.transpose(2, 3)[:, :, :, None, :]             # (B, nc, H, 1, Q)
    w = qk * decay.permute(0, 1, 4, 2, 3) * irj            # (B, nc, H, i, j)
    y_intra = torch.einsum("bchij,bcjhv->bcihv", w, vr)
    n_intra = w.sum(-1)                                    # (B, nc, H, Q)

    segl = torch.exp(cl[:, :, -1:, :] - cl)                # (B, nc, Q, H)
    kw = kr * (segl * ir)[..., None]
    S_chunk = torch.einsum("bcjhd,bcjhv->bchdv", kw, vr)
    n_chunk = kw.sum(2)                                    # (B, nc, H, Dk)
    cdecay = torch.exp(cl[:, :, -1, :])                    # (B, nc, H)

    S = torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
    n = torch.zeros((B, H, Dk), dtype=f32, device=q.device)
    S_prevs, n_prevs = [], []
    for c in range(nc):
        S_prevs.append(S)
        n_prevs.append(n)
        S = cdecay[:, c, :, None, None] * S + S_chunk[:, c]
        n = cdecay[:, c, :, None] * n + n_chunk[:, c]
    S_prev = torch.stack(S_prevs, dim=1)                   # (B, nc, H, Dk, Dv)
    n_prev = torch.stack(n_prevs, dim=1)                   # (B, nc, H, Dk)

    qe = qr * torch.exp(cl)[..., None]
    y_inter = torch.einsum("bcihd,bchdv->bcihv", qe, S_prev)
    n_inter = torch.einsum("bcihd,bchd->bcih", qe, n_prev)

    y = y_intra + y_inter                                  # (B, nc, Q, H, Dv)
    nn_ = n_intra.transpose(2, 3)[..., None] + n_inter[..., None]
    y = y / nn_.abs().clamp_min(1.0)
    return y.reshape(B, L, H, Dv).to(q.dtype), (S, n)


def gla_ref(q, k, v, i_gate, logf):
    """Sequential oracle for :func:`gla_chunked`."""
    B, L, H, Dk = q.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    S = torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
    n = torch.zeros((B, H, Dk), dtype=f32, device=q.device)
    ys = []
    for t in range(L):
        qt, kt, vt, it, ft = (a[:, t].to(f32)
                              for a in (q, k, v, i_gate, logf))
        f = torch.exp(ft)
        S = f[..., None, None] * S + it[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f[..., None] * n + it[..., None] * kt
        qs = qt * (Dk ** -0.5)
        num = torch.einsum("bhd,bhdv->bhv", qs, S)
        den = torch.einsum("bhd,bhd->bh", qs, n).abs().clamp_min(1.0)
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1).to(q.dtype), (S, n)


# --------------------------------------------------------------------------
# mLSTM block
# --------------------------------------------------------------------------
def mlstm_init(cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d
    f32 = torch.float32
    return {
        "norm": norm_init(cfg),
        "w_up": _dense_init((d, 2 * di), cfg.p_dtype),
        "conv_w": _dense_init((4, di), cfg.p_dtype, scale=0.5),
        "conv_b": Leaf((di,), cfg.p_dtype, "zeros"),
        "wq": _dense_init((di, di), cfg.p_dtype),
        "wk": _dense_init((di, di), cfg.p_dtype),
        "wv": _dense_init((di, di), cfg.p_dtype),
        "w_if": _dense_init((di, 2 * H), f32),
        # input-gate biases 0, forget-gate biases 3
        "b_if": Leaf((2 * H,), f32, "halves", 3.0),
        "w_down": _dense_init((di, d), cfg.p_dtype),
    }


def _mlstm_in(cfg: ModelConfig, p, x):
    """The mLSTM's up projection split into the cell's input and its gate
    branch z."""
    h = norm_apply(cfg, p["norm"], x)
    up = _proj(h, p["w_up"])
    return torch.chunk(up, 2, dim=-1)


def _mlstm_qkv_gates(cfg: ModelConfig, p, xc, xm):
    """q, k from the conv output, v from its input; the gates in float32."""
    H = cfg.n_heads
    q, k, v = (_proj(a, p[w]) for a, w in ((xc, "wq"), (xc, "wk"),
                                           (xm, "wv")))
    gates = torch.matmul(xc.float(), p["w_if"]) + p["b_if"]
    return q, k, v, torch.sigmoid(gates[..., :H]), F.logsigmoid(gates[..., H:])


def _mlstm_out(p, y, z, x):
    y = y * F.silu(z.float()).to(y.dtype)
    return x + _proj(y, p["w_down"])


def mlstm_apply(cfg: ModelConfig, p, x, *, chunk=128, return_state=False):
    B, L, d = x.shape
    H, di = cfg.n_heads, 2 * d
    xm, z = _mlstm_in(cfg, p, x)
    xc = _causal_conv(xm, p["conv_w"], p["conv_b"])
    q, k, v, i_gate, logf = _mlstm_qkv_gates(cfg, p, xc, xm)
    y, (S, n) = gla_chunked(q.reshape(B, L, H, -1), k.reshape(B, L, H, -1),
                            v.reshape(B, L, H, -1), i_gate, logf,
                            min(chunk, L))
    out = _mlstm_out(p, y.reshape(B, L, di), z, x)
    if return_state:
        # the conv cache holds the conv's input, the last three rows
        conv = F.pad(xm, (0, 0, max(0, 3 - L), 0))[:, -3:]
        return out, {"S": S, "n": n, "conv": conv}
    return out


def mlstm_decode(cfg: ModelConfig, p, x, state):
    """One token. x: (B, 1, d); state: {S (B, H, Dk, Dk), n (B, H, Dk),
    conv (B, 3, di)}. Returns (out, new state); the state is not changed
    in place."""
    B = x.shape[0]
    H, di = cfg.n_heads, 2 * cfg.d_model
    f32 = torch.float32
    xm, z = _mlstm_in(cfg, p, x)
    window = torch.cat([state["conv"], xm], dim=1)        # (B, 4, di)
    y = (window * p["conv_w"][None]).sum(1, keepdim=True) + p["conv_b"]
    xc = F.silu(y.float()).to(x.dtype)
    q, k, v, i_gate, logf = _mlstm_qkv_gates(cfg, p, xc, xm)
    q, k, v = (a.reshape(B, H, -1) for a in (q, k, v))
    i_gate, f = i_gate[:, 0], torch.exp(logf[:, 0])       # (B, H)
    S = f[..., None, None] * state["S"] + i_gate[..., None, None] * (
        k[..., :, None].to(f32) * v[..., None, :].to(f32))
    n = f[..., None] * state["n"] + i_gate[..., None] * k.to(f32)
    qs = q.to(f32) * (q.shape[-1] ** -0.5)
    num = torch.einsum("bhd,bhdv->bhv", qs, S)
    den = torch.einsum("bhd,bhd->bh", qs, n).abs().clamp_min(1.0)
    yv = (num / den[..., None]).reshape(B, 1, di).to(x.dtype)
    yv = yv * F.silu(z.float()).to(x.dtype)
    return x + _proj(yv, p["w_down"]), {"S": S, "n": n,
                                        "conv": window[:, 1:]}


# --------------------------------------------------------------------------
# sLSTM block (sequential; hidden-state recurrence)
# --------------------------------------------------------------------------
def slstm_init(cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {
        "norm": norm_init(cfg),
        "w_in": _dense_init((d, 4 * d), cfg.p_dtype),
        "b_in": Leaf((4 * d,), torch.float32, "zeros"),
        "r": _dense_init((H, dh, 4 * dh), cfg.p_dtype, scale=dh ** -0.5),
        "w_out": _dense_init((d, d), cfg.p_dtype),
    }


def _slstm_gates(cfg: ModelConfig, p, x):
    """The input's gate pre-activations, float32 (B, L, 4d)."""
    xin = norm_apply(cfg, p["norm"], x)
    return torch.matmul(xin.float(), p["w_in"].float()) + p["b_in"]


def _slstm_cell(cfg: ModelConfig, r, carry, gx):
    """One sLSTM step. r: (H, dh, 4 dh) float32; carry: (c, n, h, m) each
    (B, H, dh) float32; gx: (B, 4d)."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    c, n, h, m = carry
    rec = torch.einsum("bhd,hdf->bhf", h, r)
    g = gx.reshape(*gx.shape[:-1], H, 4 * dh).float() + rec
    zi, fi, ii, oi = torch.split(g, dh, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    i = torch.exp(ii - m_new)
    f = torch.exp(logf + m - m_new)
    c = f * c + i * z
    n = f * n + i
    h_new = o * c / n.clamp_min(1.0)
    return c, n, h_new, m_new


def _slstm_out(p, hs, x):
    return x + _proj(hs.to(x.dtype), p["w_out"])


def _state(carry) -> dict:
    return dict(zip(("c", "n", "h", "m"), carry))


def slstm_apply(cfg: ModelConfig, p, x, *, return_state=False):
    B, L, d = x.shape
    H = cfg.n_heads
    dh = d // H
    gx = _slstm_gates(cfg, p, x)
    r = p["r"].float()
    f32 = torch.float32
    carry = tuple(torch.zeros((B, H, dh), dtype=f32, device=x.device)
                  for _ in range(3)) + (
        torch.full((B, H, dh), -1e9, dtype=f32, device=x.device),)
    hs = []
    for t in range(L):
        carry = _slstm_cell(cfg, r, carry, gx[:, t])
        hs.append(carry[2])
    out = _slstm_out(p, torch.stack(hs, dim=1).reshape(B, L, d), x)
    if return_state:
        return out, _state(carry)
    return out


def slstm_decode(cfg: ModelConfig, p, x, state):
    """One token; the state is not changed in place."""
    B, _, d = x.shape
    gx = _slstm_gates(cfg, p, x)
    carry = _slstm_cell(cfg, p["r"].float(),
                        (state["c"], state["n"], state["h"], state["m"]),
                        gx[:, 0])
    return _slstm_out(p, carry[2].reshape(B, 1, d), x), _state(carry)
