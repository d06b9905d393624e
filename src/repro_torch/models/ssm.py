"""Mamba2 (SSD) blocks.

Counterpart of ``repro/models/ssm.py``. The SSD scan runs in its chunked
form: :func:`ssd_chunked` is the plain path (``ssm_impl="plain"``), the
hand-written kernel in ``repro_torch/kernels/ssm_scan`` the default
(``ssm_impl="kernel"``), and :func:`ssd_ref` the sequential oracle. Decode
(:func:`mamba_decode`) is one recurrence step in plain PyTorch: the
reference has no kernel for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.layers import Leaf, _dense_init, _proj


def mamba_init(cfg: ModelConfig):
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * N
    f32 = torch.float32
    return {
        "in_proj": _dense_init((d, 2 * din + 2 * N + H), cfg.p_dtype),
        "conv_w": _dense_init((cfg.ssm_conv, conv_ch), cfg.p_dtype,
                              scale=cfg.ssm_conv ** -0.5),
        "conv_b": Leaf((conv_ch,), cfg.p_dtype, "zeros"),
        "A_log": Leaf((H,), f32, "zeros"),
        "D": Leaf((H,), f32, "ones"),
        "dt_bias": Leaf((H,), f32, "zeros"),
        "norm_scale": Leaf((din,), cfg.p_dtype, "ones"),
        "out_proj": _dense_init((din, d), cfg.p_dtype),
    }


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """x: (B, L, C); w: (K, C) depthwise causal conv, SiLU in float32."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:L, :] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + L, :] * w[i]
    y = y + b
    return F.silu(y.float()).to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan in plain PyTorch (the reference's XLA path).

    x: (B, L, H, P); dt: (B, L, H) positive; A: (H,) negative; Bm, Cm:
    (B, L, N). Returns y: (B, L, H, P) in x's dtype, final_state: (B, H,
    N, P) float32. The reference's three-operand products are taken as
    two pairwise ones, so no (..., Q, Q, H, P) tensor is formed.
    """
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = ssm_ops.chunk_of(L, chunk)
    nc = L // Q
    f32 = torch.float32
    xr = x.reshape(B, nc, Q, H, P).to(f32)
    dtr = dt.reshape(B, nc, Q, H).to(f32)
    Br = Bm.reshape(B, nc, Q, N).to(f32)
    Cr = Cm.reshape(B, nc, Q, N).to(f32)

    loga = dtr * A.to(f32)                               # (B, nc, Q, H)
    cl = torch.cumsum(loga, dim=2)                       # inclusive

    # intra-chunk: y[i] += sum_{j<=i} C_i.B_j exp(cl_i - cl_j) dt_j x_j
    CB = torch.einsum("bciN,bcjN->bcij", Cr, Br)         # (B, nc, Q, Q)
    seg = cl[:, :, :, None, :] - cl[:, :, None, :, :]    # (B, nc, Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  torch.full((), -torch.inf,
                                             device=x.device)))
    xdt = xr * dtr[..., None]                            # (B, nc, Q, H, P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", CB[..., None] * decay, xdt)

    # chunk summaries: S_c = sum_j exp(cl_last - cl_j) dt_j B_j x_j^T
    segl = torch.exp(cl[:, :, -1:, :] - cl)              # (B, nc, Q, H)
    S_chunk = torch.einsum("bcjN,bcjhp->bchNp", Br,
                           xr * (segl * dtr)[..., None])
    chunk_decay = torch.exp(cl[:, :, -1, :])             # (B, nc, H)

    S = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = chunk_decay[:, c, :, None, None] * S + S_chunk[:, c]
    S_prev = torch.stack(S_prevs, dim=1)                 # (B, nc, H, N, P)

    # inter-chunk: y[i] += C_i exp(cl_i) . S_prev
    y_inter = torch.einsum("bciN,bchNp->bcihp", Cr, S_prev) \
        * torch.exp(cl)[..., None]
    y = (y_intra + y_inter).reshape(B, L, H, P)
    return y.to(x.dtype), S


def ssd_ref(x, dt, A, Bm, Cm):
    """Sequential oracle for :func:`ssd_chunked` and the kernel."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    S = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(L):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        a = torch.exp(dtt * A.to(f32)[None])             # (B, H)
        S = a[:, :, None, None] * S + torch.einsum(
            "bh,bN,bhp->bhNp", dtt, Bm[:, t].to(f32), xt)
        ys.append(torch.einsum("bN,bhNp->bhp", Cm[:, t].to(f32), S))
    return torch.stack(ys, dim=1).to(x.dtype), S


def _gated_norm(p, y, z, dtype):
    """Mamba2's gated RMSNorm before out_proj (eps 1e-5)."""
    yz = y * F.silu(z.float()).to(y.dtype)
    ms = (yz.float() ** 2).mean(-1, keepdim=True)
    return (yz.float() * torch.rsqrt(ms + 1e-5)
            * p["norm_scale"].float()).to(dtype)


def _split(cfg: ModelConfig, zxbcdt):
    din, N = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [din, din, N, N, cfg.ssm_heads], dim=-1)


def mamba_apply(cfg: ModelConfig, p, x, *, return_state=False):
    """Full-sequence Mamba2 mixer. x: (B, L, d)."""
    B, L, _ = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = _proj(x, p["in_proj"])
    z, _, _, _, dt = _split(cfg, zxbcdt)
    conv_in = zxbcdt[..., din:2 * din + 2 * N]           # [xs, Bm, Cm]
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(conv_out, [din, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    xh = xs.reshape(B, L, H, P)
    if cfg.ssm_impl == "plain":
        y, S = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    else:
        y, S = ssm_ops.ssm_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, L, din)
    out = _proj(_gated_norm(p, y, z, x.dtype), p["out_proj"])
    if return_state:
        K = cfg.ssm_conv
        conv_state = conv_in[:, -(K - 1):, :] if L >= K - 1 else F.pad(
            conv_in, (0, 0, K - 1 - L, 0))
        return out, {"ssm": S, "conv": conv_state}
    return out


def mamba_decode(cfg: ModelConfig, p, x, state):
    """Single-token decode. x: (B, 1, d); state: {ssm (B, H, N, P), conv
    (B, K-1, C)}. Returns (out, new state); the state is not changed in
    place."""
    B = x.shape[0]
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = _proj(x, p["in_proj"])
    z, _, _, _, dt = _split(cfg, zxbcdt)
    conv_in = zxbcdt[..., din:2 * din + 2 * N]           # (B, 1, C)
    window = torch.cat([state["conv"], conv_in], dim=1)  # (B, K, C)
    y = (window * p["conv_w"][None]).sum(dim=1, keepdim=True) + p["conv_b"]
    conv_out = F.silu(y.float()).to(x.dtype)
    xs, Bm, Cm = torch.split(conv_out, [din, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])[:, 0]       # (B, H)
    A = -torch.exp(p["A_log"])

    xh = xs.reshape(B, H, P).float()
    a = torch.exp(dt * A[None])                          # (B, H)
    S = a[:, :, None, None] * state["ssm"] + torch.einsum(
        "bh,bN,bhp->bhNp", dt, Bm[:, 0].float(), xh)
    yh = torch.einsum("bN,bhNp->bhp", Cm[:, 0].float(), S)
    yh = yh + xh * p["D"][None, :, None]
    yv = yh.reshape(B, 1, din).to(x.dtype)
    out = _proj(_gated_norm(p, yv, z, x.dtype), p["out_proj"])
    return out, {"ssm": S, "conv": window[:, 1:, :]}
