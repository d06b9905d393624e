"""The arithmetic of the SSD scan's tensor-core kernel, emulated in PyTorch
on the CPU and held against the JAX package's scan (Pallas in interpret
mode) and its sequential oracle ``ssd_ref``.

The kernel (``csrc/ssm_scan.cu``, ``ssd_scan_tc_kernel``) runs only on the
card. What its design changes in the arithmetic is emulated here step for
step, at ``tests/test_kernels.py``'s SSD shapes (the scan of
``chip_smoke.py``'s ``SSD_CASES`` less the full-width one) and at the serve
path's per-head shape (Q = 128, N = P = 64) with fewer heads and chunks:

- every float32 operand of a product is split as a = hi + lo, hi =
  cvt.rna.tf32(a) (nearest, ties away from zero, 10 mantissa bits) and lo
  = cvt.rna.tf32(a - hi);
- each ``mma.sync`` m16n8k8 adds the exact sum of its 8 products to the
  float32 accumulator, which rounds once; a product over K runs in k-steps
  of 8, each as lo*hi, then hi*lo, then hi*hi (3xTF32); a bfloat16 x is
  exact in TF32 and takes lo*x, then hi*x;
- per chunk: cl is the float64 cumsum of loga rounded once; y starts as
  exp(cl_i) (C S), then W x is added 8 columns j at a time, W = (C B^T)
  exp(cl_i - cl_j) dt_j for j <= i and 0 above, C B^T summed in two
  chains (even and odd k-steps) added at the end; the state becomes
  exp(cl_last) S, then (B cf)^T x is added 8 rows j at a time, cf_j =
  exp(cl_last - cl_j) dt_j.

Held within the unchanged SSD tolerances: y and the final state within
2e-4 in float32; in bfloat16, y within 2e-2 (one bf16 rounding), y before
that rounding within 2e-4 of the float32 scan of the same values, and the
state within 2e-4. The same emulation with one TF32 pass per product
(hi*hi only) is recorded beside it: its error is what the split buys.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ops as jssm
from repro.models import ssm as jssm_model
from repro_torch.kernels import ssm_scan

TOL = 2e-4
BF16_Y_TOL = 2e-2
# B, L, H, P, N, chunk: tests/test_kernels.py's SSD shapes, then the serve
# path's per-head shape with 2 heads and 2 chunks.
CASES = [(2, 64, 2, 32, 16, 16), (2, 128, 4, 64, 64, 32),
         (2, 96, 1, 16, 8, 32), (2, 256, 2, 64, 32, 128),
         (1, 256, 2, 64, 64, 128)]


def tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half an ulp of TF32 to the magnitude, then clear
    the 13 low bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def mma(d, a, b):
    """One m16n8k8 step: d + a @ b with the 8 products summed exactly and
    one float32 rounding."""
    return (d.double() + a.double() @ b.double()).float()


def product(d, a, b, passes: str, b_exact: bool = False, steps=None):
    """d + a @ b over K in k-steps of 8 (``steps``: their first columns,
    all of them by default): 3xTF32 (lo*hi, hi*lo, hi*hi; lo*hi and hi*hi
    only when b is exact in TF32) or one pass (hi*hi)."""
    for k0 in steps if steps is not None else range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, al = split(ak)
        bh, bl = (bk, None) if b_exact else split(bk)
        if passes == "1x":
            d = mma(d, ah, bh)
            continue
        d = mma(d, al, bh)
        if not b_exact:
            d = mma(d, ah, bl)
        d = mma(d, ah, bh)
    return d


def emulate(x, dt, A, Bm, Cm, chunk, passes="3x"):
    """The tensor-core kernel's arithmetic. x (B, L, H, P) float32 or
    bfloat16; returns (y before its rounding to x's dtype, float32; the
    final state (B, H, N, P))."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    f32 = torch.float32
    exact = x.dtype == torch.bfloat16
    loga = dt * A[None, None, :]
    S = torch.zeros(B, H, N, P)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, L, Q):
        sl = slice(c0, c0 + Q)
        xc = x[:, sl].to(f32).permute(0, 2, 1, 3)            # (B, H, Q, P)
        dtc = dt[:, sl].permute(0, 2, 1)                      # (B, H, Q)
        cl = loga[:, sl].permute(0, 2, 1).double().cumsum(-1).float()
        ecl = torch.exp(cl)
        cf = torch.exp(cl[..., -1:] - cl) * dtc
        Cc = Cm[:, sl][:, None]                                # (B, 1, Q, N)
        BcT = Bm[:, sl].transpose(1, 2)[:, None]               # (B, 1, N, Q)
        y = product(torch.zeros(B, H, Q, P), Cc.expand(B, H, Q, N), S,
                    passes) * ecl[..., None]
        for j0 in range(0, Q, 8):
            js = slice(j0, j0 + 8)
            # C.B^T in two chains, the even and the odd k-steps, added
            cb = [product(torch.zeros(B, H, Q, 8), Cc.expand(B, H, Q, N),
                          BcT[..., js].expand(B, H, N, 8), passes,
                          steps=range(k0, N, 16)) for k0 in (0, 8)]
            cb = cb[0] + cb[1]
            seg = cl[..., :, None] - cl[..., None, js]
            keep = causal[:, js]
            w = torch.where(keep, cb * torch.exp(torch.where(keep, seg, 0.0))
                            * dtc[..., None, js], torch.zeros(()))
            y = product(y, w, xc[..., js, :], passes, b_exact=exact)
        ys.append(y)
        S = torch.exp(cl[..., -1])[..., None, None] * S
        for j0 in range(0, Q, 8):
            js = slice(j0, j0 + 8)
            a = (Bm[:, sl][:, None, js, :] * cf[..., js, None]).transpose(2, 3)
            S = product(S, a, xc[..., js, :], passes, b_exact=exact)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), S


def inputs(B, L, H, P, N, dtype, seed):
    """``test_kernels.py``'s distributions: x, B, C ~ 0.5 N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(0.3 N(0, 1)); x rounded to ``dtype`` once,
    so that both sides see the same values."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((B, L, H, P)) * 0.5).astype(np.float32).astype(
        dtype)
    dt = np.logaddexp(r.standard_normal((B, L, H)), 0).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (r.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    Cm = (r.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def max_err(a, b) -> float:
    return float(np.abs(f32(a).astype(np.float64)
                        - f32(b).astype(np.float64)).max())


def references(args, chunk):
    """The JAX scan (Pallas, interpret mode) and ``ssd_ref``, both on the
    float32 values of the inputs: (y, S) pairs, float32."""
    up = [np.asarray(a, np.float32) for a in args]
    jy, jS = jssm.ssm_scan(*map(jnp.asarray, up), chunk=chunk, interpret=True)
    ry, rS = jssm_model.ssd_ref(*map(jnp.asarray, up))
    return (jy, jS), (ry, rS)


def test_tf32_rounding_is_nearest_with_ties_away_from_zero():
    one = 0x3F800000
    bits = torch.tensor([one, one + 0x0FFF, one + 0x1000, one + 0x1001,
                         one + 0x3000, one | 0x7FFFF000 & 0x7FFFFF],
                        dtype=torch.int32)
    for sign in (1.0, -1.0):
        a = bits.view(torch.float32) * sign
        got = tf32(a).view(torch.int32) & 0x7FFFFFFF
        assert got.tolist() == [one, one, one + 0x2000, one + 0x2000,
                                one + 0x4000, 0x40000000]
        # a - hi is exact and lo rounds it to 11 significant bits, so hi +
        # lo is a to within 2^-22 |a|
        hi, lo = split(a)
        assert torch.equal((a.double() - hi.double()).float(), a - hi)
        assert bool(((hi + lo - a).abs() <= 2.0 ** -22 * a.abs()).all())


def test_bfloat16_is_exact_in_tf32():
    r = np.random.default_rng(0)
    x = to_torch((r.standard_normal(4096) * 3).astype(ml_dtypes.bfloat16))
    assert torch.equal(tf32(x.float()), x.float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,N,chunk", CASES)
def test_tensor_core_arithmetic_matches_jax(B, L, H, P, N, chunk, dtype,
                                            record_property):
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    args = inputs(B, L, H, P, N, np_dt, B * L + H + P + N)
    targs = tuple(map(to_torch, args))
    y, S = emulate(*targs, chunk=chunk)
    y1, S1 = emulate(*targs, chunk=chunk, passes="1x")
    (jy, jS), (ry, rS) = references(args, chunk)
    errs = {"3xTF32": max(max_err(y, jy), max_err(S, jS), max_err(y, ry),
                          max_err(S, rS)),
            "1xTF32": max(max_err(y1, jy), max_err(S1, jS), max_err(y1, ry),
                          max_err(S1, rS))}
    record_property("max_abs_err", errs)
    # y before its rounding, and the state, at float32-level accuracy
    assert errs["3xTF32"] <= TOL, errs
    # y in x's dtype within the tolerance of its dtype
    y_out = y.to(targs[0].dtype)
    jy_out = jssm.ssm_scan(*map(jnp.asarray, args), chunk=chunk,
                           interpret=True)[0]
    assert max_err(y_out, jy_out) <= (TOL if dtype == "float32"
                                      else BF16_Y_TOL)


@pytest.mark.parametrize("B,L,H,P,N,chunk", CASES)
def test_one_tf32_pass_is_not_enough(B, L, H, P, N, chunk, record_property):
    """One TF32 pass per product (10 mantissa bits) misses float32-level
    accuracy by far: its error against the JAX scan is at least 10 x the
    split's and more than half the 2e-4 tolerance, so it could not hold
    2e-4 with a margin of 2 x at these shapes."""
    args = inputs(B, L, H, P, N, np.float32, B * L + H + P + N)
    targs = tuple(map(to_torch, args))
    (jy, jS), _ = references(args, chunk)
    err = {}
    for passes in ("3x", "1x"):
        y, S = emulate(*targs, chunk=chunk, passes=passes)
        err[passes] = max(max_err(y, jy), max_err(S, jS))
    record_property("max_abs_err", err)
    assert err["1x"] >= 10 * err["3x"] and err["1x"] > TOL / 2, err


def test_emulation_is_the_plain_scan_without_tf32():
    """With the splits taken away (every operand passed whole) the
    emulation is the plain version's arithmetic in another order: they
    agree far inside the tolerance, so the error above is TF32's."""
    args = tuple(map(to_torch, inputs(2, 128, 3, 32, 16, np.float32, 5)))
    global tf32
    keep = tf32
    try:
        tf32 = lambda a: a  # noqa: E731
        y, S = emulate(*args, chunk=64)
    finally:
        tf32 = keep
    py, pS = ssm_scan.ssd_scan_plain(*args, chunk=64)
    assert max_err(y, py) <= 1e-5 and max_err(S, pS) <= 1e-5
