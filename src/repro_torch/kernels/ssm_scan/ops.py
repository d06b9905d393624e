"""The chunked Mamba2 (SSD) scan: the wrapper and its plain version.

Counterpart of ``repro/kernels/ssm_scan`` (``ops.ssm_scan`` over the TPU
kernel ``ssd_scan_bhlp``), with the contract of
``repro_torch.models.ssm.ssd_chunked``: x (B, L, H, P), dt (B, L, H), A
(H,), Bm and Cm (B, L, N); returns y (B, L, H, P) in x's dtype and the
final state (B, H, N, P) in float32. L must be a multiple of the chunk
``Q = min(chunk, L)``.

Per (b, h) and chunk, with ``loga = dt * A`` formed here in float32 and
``cl`` its inclusive cumsum inside the chunk (taken in float64 and
rounded once, so that it does not depend on the order of the sum), the
kernel computes

    y_i  = sum_{j <= i} (C_i . B_j) exp(cl_i - cl_j) dt_j x_j
           + exp(cl_i) C_i . S
    S   <- exp(cl_last) S + sum_j B_j (x_j exp(cl_last - cl_j) dt_j)^T

carrying the (N, P) state S from chunk to chunk, all in float32. The
decay is formed only for j <= i: for j > i ``exp`` could overflow, and a
mask times inf would give NaN.

The wrapper runs :func:`ssd_scan_plain` when every input lies on the CPU,
and otherwise launches one of the two CUDA kernels of ``csrc/ssm_scan.cu``
or raises. The shape chooses the kernel (:func:`tensor_core_route`): the
tensor-core route (``ssd_scan_tc``: the products on ``mma.sync`` TF32,
each float32 operand split in two, 3xTF32) where Q, N and P sit on the
tensor cores' grain, the CUDA-core route (``ssd_scan``) elsewhere.
``LAUNCHES`` counts each route's launches, and nothing else. The wrapper
is the roofline walker's kernel scope with :func:`ssm_scan_cost`
(whichever route); under the walker, ``meta`` inputs give empty ``meta``
outputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    DTYPE_CODES,
    INT,
    LL,
    PTR,
    cuda_device,
    empty_meta,
    on_cpu,
    raise_on,
    refuse_autograd,
    rule,
    stream_ptr,
    tensor_bytes,
)
from repro_torch.roofline import hw, walk

#: Kernel launches since the last reset, by route (the CPU path never
#: counts): ``ssd_scan_tc`` the tensor cores, ``ssd_scan`` the CUDA cores.
LAUNCHES = {"ssd_scan": 0, "ssd_scan_tc": 0}
#: Dtypes whose values TF32 holds exactly.
_TF32_EXACT = (torch.bfloat16, torch.float16)
#: Shared memory one block may use on the card (H100: 227 KB).
MAX_SHARED_BYTES = 232_448

_LIB: list = []


def _lib():
    if not _LIB:
        lib = build.load("ssm_scan")
        lib.ssd_scan_launch.argtypes = (
            [PTR] * 7 + [INT] * 7 + [INT] + [LL] * 3 + [PTR])
        lib.ssd_scan_launch.restype = INT
        lib.ssd_scan_tc_launch.argtypes = (
            [PTR] * 7 + [INT] * 7 + [INT] + [LL] * 3 + [INT] + [PTR])
        lib.ssd_scan_tc_launch.restype = INT
        _LIB.append(lib)
    return _LIB[0]


def chunk_of(L: int, chunk: int) -> int:
    """The chunk length ``min(chunk, L)``; raises unless it divides L."""
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"seq {L} not divisible by chunk {Q}")
    return Q


def shared_bytes(Q: int, N: int, P: int) -> int:
    """The kernel's shared memory for chunk Q, state N and head dim P:
    B (at an odd row stride) and C tiles, x, the (Q, Q) weights, the
    (N, P) state and four length-Q vectors, float32."""
    return 4 * (Q * (N | 1) + Q * N + Q * P + Q * Q + N * P + 4 * Q)


def tensor_core_route(Q: int, N: int, P: int) -> bool:
    """Whether the scan of chunk Q, state N and head dim P runs on the
    tensor cores: Q a multiple of 16 up to 128, N of 16 up to 64, P of 8
    up to 64 (the serve path's 128, 64, 64 does)."""
    return (Q % 16 == 0 and 16 <= Q <= 128 and N % 16 == 0 and 16 <= N <= 64
            and P % 8 == 0 and 8 <= P <= 64)


def tc_shared_bytes(Q: int, itemsize: int) -> int:
    """The tensor-core kernel's shared memory: a 2-stage ring of (Q, 64)
    x tiles in x's dtype, the (Q, 64) float32 B tile, the (64, 64) state
    as (S, lo) float32 pairs, each zero-padded past N and P, and four
    length-Q float32 vectors."""
    return 2 * Q * 64 * itemsize + 4 * Q * 64 + 8 * 64 * 64 + 16 * Q


def _aligned16(x) -> bool:
    """Whether x's base and its strides in bytes are multiples of 16."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        (st * size) % 16 == 0 for st in x.stride()[:3])


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """What the ``ssd_scan`` kernel computes, in PyTorch ops, chunk by
    chunk over all (b, h) at once. Arguments and results as
    :func:`ssm_scan`."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_of(L, chunk)
    f32 = torch.float32
    dtf = dt.to(f32)
    loga = dtf * A.to(f32)[None, None, :]
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    S = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, L, Q):
        sl = slice(c0, c0 + Q)
        xc = x[:, sl].to(f32).permute(0, 2, 1, 3)          # (B, H, Q, P)
        dtc = dtf[:, sl].permute(0, 2, 1)                   # (B, H, Q)
        cl = loga[:, sl].permute(0, 2, 1).to(torch.float64).cumsum(-1).to(
            f32)                                            # inclusive
        Bc, Cc = Bf[:, sl], Cf[:, sl]                       # (B, Q, N)
        seg = cl[..., :, None] - cl[..., None, :]           # cl_i - cl_j
        decay = torch.exp(torch.where(causal, seg,
                                      torch.full((), -torch.inf,
                                                 device=x.device)))
        CB = (Cc @ Bc.transpose(1, 2))[:, None]             # (B, 1, Q, Q)
        w = CB * decay * dtc[..., None, :]
        y = w @ xc + torch.exp(cl)[..., None] * (Cc[:, None] @ S)
        segl = torch.exp(cl[..., -1:] - cl)
        xw = xc * (segl * dtc)[..., None]
        S = torch.exp(cl[..., -1])[..., None, None] * S \
            + Bc.transpose(1, 2)[:, None] @ xw
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(x.dtype), S


def ssd_products(B, H, L, P, N, Q, x_dtype, b_dtype, c_dtype) -> tuple:
    """The scan's four products and the least seconds the tensor cores
    take for them at float32 accuracy: ``(operations, seconds, rate
    named)``. Per (b, h) and chunk: C.B^T and W x over the causal
    triangle (Q (Q + 1) / 2 pairs), C.S and the state update 2 Q N P
    operations each. A float32 operand is split into two TF32 parts, so
    a product of two float32 operands takes three TF32 passes, one whose
    other operand is exact in TF32 (bf16, fp16) two, and one of two such
    operands runs once on the bf16 tensor cores. W, S and B dt exp(..)
    are float32: W x and the state update take two passes with a bf16 x,
    C.S two with a bf16 C."""
    n = B * H * (L // Q)
    tri = Q * (Q + 1) // 2
    cb, wx = 2 * n * tri * N, 2 * n * tri * P
    cs = st = 2 * n * Q * N * P
    exact = {name: dt in _TF32_EXACT for name, dt in
             (("x", x_dtype), ("B", b_dtype), ("C", c_dtype))}

    def passes(*ops_exact):
        return 3 - sum(ops_exact)

    if exact["B"] and exact["C"]:
        s_cb, named = cb / hw.PEAK_FLOPS_BF16, "C.B^T at the bf16 rate"
    else:
        k = passes(exact["B"], exact["C"])
        s_cb, named = k * cb / hw.PEAK_FLOPS_TF32, f"C.B^T in {k} TF32 passes"
    kx, kc = passes(exact["x"]), passes(exact["C"])
    secs = s_cb + (kx * (wx + st) + kc * cs) / hw.PEAK_FLOPS_TF32
    named += (f", W x and the state update in {kx}, C.S in {kc} TF32 "
              f"passes (495 TFLOP/s each)")
    return cb + wx + cs + st, secs, named


def ssm_scan_cost(x, dt, A, Bm, Cm, *, chunk: int = 128) -> dict:
    """Every input read once, y and the final state written once; the
    four products of :func:`ssd_products` at the rate their TF32 passes
    give (the tensor cores' least time at float32 accuracy)."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    ops, secs, _ = ssd_products(B, H, L, P, N, chunk_of(L, chunk), x.dtype,
                                Bm.dtype, Cm.dtype)
    return rule(ops, tensor_bytes(x, dt, A, Bm, Cm, x) + B * H * N * P * 4,
                ops / secs, ops)


def _ssm_scan_meta(x, dt, A, Bm, Cm, *, chunk: int = 128):
    B, L, H, P = x.shape
    chunk_of(L, chunk)
    return empty_meta(x.shape, x.dtype), empty_meta((B, H, Bm.shape[-1], P),
                                          torch.float32)


@walk.kernel("ssm_scan", ssm_scan_cost, _ssm_scan_meta)
def ssm_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The chunked SSD scan as one kernel call.

    x (B, L, H, P) float32 or bfloat16, read through its strides (the
    model passes a view into the conv output); dt (B, L, H), A (H,), Bm
    and Cm (B, L, N), any float dtype (taken to float32 here). Returns
    ``(y (B, L, H, P) in x's dtype, S (B, H, N, P) float32)``.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L, H, P), got {tuple(x.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    for name, t, shape in (("dt", dt, (B, L, H)), ("A", A, (H,)),
                           ("Bm", Bm, (B, L, N)), ("Cm", Cm, (B, L, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    refuse_autograd("ssm_scan", x, dt, A, Bm, Cm)
    Q = chunk_of(L, chunk)
    if on_cpu(x, dt, A, Bm, Cm):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    dev = cuda_device(x)
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    tc = tensor_core_route(Q, N, P)
    if not tc and shared_bytes(Q, N, P) > MAX_SHARED_BYTES:
        raise ValueError(f"chunk {Q}, state {N}, head dim {P} need "
                         f"{shared_bytes(Q, N, P)} B of shared memory, above "
                         f"{MAX_SHARED_BYTES}")
    f32 = torch.float32
    if x.stride(-1) != 1 or (tc and not _aligned16(x)):
        x = x.contiguous()
    dtf = dt.to(f32).contiguous()
    loga = (dtf * A.to(f32)[None, None, :]).contiguous()
    Bf, Cf = Bm.to(f32).contiguous(), Cm.to(f32).contiguous()
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    S = torch.empty((B, H, N, P), dtype=f32, device=dev)
    route = "ssd_scan_tc" if tc else "ssd_scan"
    launch = _lib().ssd_scan_tc_launch if tc else _lib().ssd_scan_launch
    smem = tc_shared_bytes(Q, x.element_size()) if tc else \
        shared_bytes(Q, N, P)
    # bfloat16 and float16 B and C are exact in TF32: the tensor-core
    # kernel then leaves out the products of their (zero) lo parts
    exact = ([int(Bm.dtype in _TF32_EXACT and Cm.dtype in _TF32_EXACT)]
             if tc else [])
    rc = launch(
        x.data_ptr(), dtf.data_ptr(), loga.data_ptr(), Bf.data_ptr(),
        Cf.data_ptr(), y.data_ptr(), S.data_ptr(), B, L, H, P, N, Q, smem,
        DTYPE_CODES[x.dtype], *x.stride()[:3], *exact, stream_ptr(dev))
    raise_on(rc, route)
    LAUNCHES[route] += 1
    return y, S
