"""The paper's closed-form scheduling math (Eqs. 1-4), in PyTorch.

Counterpart of ``repro/core/equations.py``; every function broadcasts
over leading dims. Decision arithmetic is float32 with one rounding per
operation (no fused multiply-add), and a reduction over a small axis
that feeds a decision is an explicit left-to-right sum
(:func:`seq_sum`), so that the CPU and the card round alike. Means
follow the reference's compiled form op for op: the sum times the
float32 reciprocal of the count (:func:`seq_mean`).

Feasibility: a pair is feasible iff ``s + e <= delta`` (see the JAX
module's note on Algorithm 2).

Trace synthesis runs on the host in numpy; :func:`cumsum32` and
:func:`exp32` give it the reference's compiled float32 prefix sum and
exponential, so that its transforms of random draws round as the
reference's do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32

BIG = 1e30  # "no value" sentinel of keys and scores (float32 1e30)


def seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Left-to-right float sum over a small axis: ``((x0 + x1) + x2) ...``."""
    x = x.movedim(dim, -1)
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def seq_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """:func:`seq_sum` times the float32 reciprocal of the count: the
    reference's compiled mean turns its division by a constant into that
    multiplication."""
    return seq_sum(x, dim) * (1.0 / x.shape[dim])


def seq_dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Left-to-right float32 sum of products, ``acc = fma(a_i, b_i,
    acc)``, as :func:`seq_sumsq` forms it: XLA's CPU code contracts the
    products of a fused multiply-reduce the same way. ``a`` and ``b``
    broadcast."""
    # repro: allow-f64[a product of float32s is exact in float64]
    prod = (a.double() * b.double()).movedim(dim, -1)
    acc = prod[..., 0].to(F32)  # repro: allow-f64[the first term, rounded]
    for i in range(1, prod.shape[-1]):
        # repro: allow-f64[the fused multiply-add's sum, rounded once]
        acc = (prod[..., i] + acc.double()).to(F32)
    return acc


def seq_sumsq(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Left-to-right float32 sum of squares with a fused multiply-add per
    term, ``acc = fma(x_i, x_i, acc)``: the reference's compiled CPU
    reduction contracts the square into the accumulation. Each term is
    formed in float64, where ``x_i * x_i`` of a float32 is exact, and
    rounded once to float32."""
    # repro: allow-f64[the square of a float32 is exact in float64]
    x = x.movedim(dim, -1).double()
    acc = torch.zeros_like(x[..., 0], dtype=F32)  # repro: allow-f64[a view]
    for i in range(x.shape[-1]):
        # repro: allow-f64[the fused multiply-add's sum, rounded once]
        acc = (x[..., i] * x[..., i] + acc.double()).to(F32)
    return acc


SCAN_BLOCK = 16  # block length of XLA's CPU prefix sum


def cumsum32(x) -> np.ndarray:
    """Inclusive float32 prefix sums along the last axis, in the order of
    XLA's CPU scan (``jnp.cumsum``), which is not a left-to-right sum.

    Up to :data:`SCAN_BLOCK` elements are summed left to right. A longer
    axis is cut into blocks of 16 (the last one short): prefix sums left
    to right within each block, the block totals scanned by the same rule,
    and each block's exclusive carry added to its sums.
    """
    x = np.asarray(x, np.float32)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return np.cumsum(x, axis=-1, dtype=np.float32)
    nb = -(-n // SCAN_BLOCK)
    pad = np.zeros(x.shape[:-1] + (nb * SCAN_BLOCK - n,), np.float32)
    blocks = np.cumsum(np.concatenate([x, pad], -1).reshape(
        x.shape[:-1] + (nb, SCAN_BLOCK)), axis=-1, dtype=np.float32)
    carry = cumsum32(blocks[..., -1])
    blocks[..., 1:, :] += carry[..., :-1, None]
    return blocks.reshape(x.shape[:-1] + (nb * SCAN_BLOCK,))[..., :n]


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)  # repro: allow-f64[host-side trace synthesis]
            + np.asarray(c, np.float64)).astype(np.float32)


_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp32(x) -> np.ndarray:
    """float32 ``exp`` as XLA's CPU code computes it (not correctly
    rounded): n = floor(x log2(e) + 1/2) clamped to [-127, 127], Cody-Waite
    reduction r = x - n ln 2 in two fused multiply-adds, Cephes'
    degree-5 polynomial evaluated with fused multiply-adds, times 2^n.
    Inputs are clamped to [-87.8, 88.8]; results below 2^-126 flush to
    zero."""
    f32 = np.float32
    x = np.clip(np.asarray(x, f32), f32(-87.8), f32(88.8))
    n = np.clip(np.floor(_fma32(x, f32(1.44269504088896341), f32(0.5))),
                -127, 127).astype(f32)
    r = _fma32(n, f32(-0.693359375), x)
    r = _fma32(n, f32(2.12194440e-4), r)
    z = _fma32(r, f32(_EXP_POLY[0]), f32(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        z = _fma32(z, r, f32(c))
    z = (f32(1) + _fma32(z, r * r, r)).astype(f32)
    pow2 = ((n.astype(np.int32) + 127) << 23).view(f32)
    with np.errstate(over="ignore"):
        y = (z * pow2).astype(f32)
    return np.where(y < np.finfo(f32).tiny, f32(0), y)


def exact_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device (float64
    sqrt then one rounding; PyTorch's vectorized CPU float32 sqrt is not
    always correctly rounded)."""
    # repro: allow-f64[float64 sqrt rounded once is the correctly rounded one]
    return torch.sqrt(x.double()).to(F32)


def completion_time(start, exec_time, deadline):
    """Eq. 1 — expected completion time of a task mapped at ``start``."""
    s, e, d = torch.broadcast_tensors(start, exec_time, deadline)
    on_time = s + e <= d
    started = s < d
    return torch.where(on_time, s + e, torch.where(started, d, s))


def feasible(start, exec_time, deadline):
    """A [task, machine] pair is feasible iff it completes by the deadline."""
    return start + exec_time <= deadline


def expected_energy(start, exec_time, deadline, p_dyn):
    """Eq. 2 — expected dynamic energy of executing the pair."""
    s, e, d, p = torch.broadcast_tensors(start, exec_time, deadline, p_dyn)
    on_time = s + e <= d
    started = s < d
    zero = torch.zeros((), dtype=F32, device=s.device)
    return torch.where(on_time, p * e, torch.where(started, p * (d - s), zero))


def fairness_limit(completion_rates, fairness_factor):
    """Eq. 3 — epsilon = mu - f * sigma over per-type completion rates.

    sigma is the population standard deviation (ddof 0), clamped at 0.
    Reduces over the last axis. Bit-exact with the reference's compiled
    form at any type count up to 16 (checked over random rates for 2 to
    16 types; ``range`` has 6): mu and the sum of squares left to right,
    each square fused into the accumulation, times the float32 reciprocal
    of the count. ``mu - f * sigma`` rounds once, as the reference's
    compiled code contracts it into a fused multiply-add; two roundings
    differ in the last place for an ``f`` such as 0.7, and agree when
    ``f`` is a power of two (the paper's 1), whose product is exact.
    """
    cr = completion_rates.to(F32)
    mu = seq_mean(cr)
    centered = cr - mu[..., None]
    sigma = exact_sqrt(seq_sumsq(centered) * (1.0 / cr.shape[-1]))
    f = float(np.float32(fairness_factor))
    if math.frexp(f)[0] == 0.5:
        eps = mu - f * sigma
    else:
        # repro: allow-f64[mu - f * sigma rounded once, as XLA's FMA]
        eps = (mu.double() - f * sigma.double()).to(F32)
    return torch.clamp(eps, min=0.0)


def deadlines(arrival, task_type, eet):
    """Eq. 4 — delta_i(k) = arr_k + e_bar_i + e_bar."""
    eet = eet.to(F32)
    e_bar_i = seq_mean(eet, dim=1)                    # (S,)
    e_bar = seq_mean(e_bar_i, dim=0)                  # ()
    return arrival.to(F32) + e_bar_i[task_type] + e_bar


def hash_machine(n_tasks: int, now: torch.Tensor, n_machines: int):
    """(B, N) int64 ``(idx * 2654435761 + uint32(now * 1e3)) % M`` with
    uint32 wrap-around, computed in int64 and masked to 32 bits: the
    random nominator's machine for every task of every replicate."""
    mask = 0xFFFFFFFF
    idx = torch.arange(n_tasks, device=now.device, dtype=torch.int64)
    salt = (now * 1e3).to(torch.int64) & mask                  # (B,)
    h = ((idx * 2654435761) & mask)[None, :] + salt[:, None]
    return (h & mask) % n_machines


def urgency(deadline, exec_time, now):
    """MMU's urgency metric: 1 / (delta - now - e). Higher = more urgent."""
    slack = deadline - now - exec_time
    eps = torch.full_like(slack, 1e-9)
    return 1.0 / torch.where(slack.abs() < 1e-9, eps, slack)
