"""Blockwise online-softmax attention: the wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention`` (``ops.flash_attention``
over the TPU kernel ``flash_attention_bhsd``). Both take the model layout:
q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), and return (B, Sq, H, hd) in
q's dtype. Query head h reads key/value head ``h // (H // Hkv)`` (GQA).

The semantics are the TPU kernel's, not XLA's: ``q * hd**-0.5`` is formed
in float32 before the product, a key that the causal mask (query position
``q_offset + i`` against key position j) or the ``kv_len`` bound excludes
scores the finite ``-1e30``, and the output divides by ``max(l, 1e-30)``.
A row with no valid key therefore gives the mean of V over the Sk keys,
where XLA's ``-inf`` gives NaN. Scores, the softmax and the sums are
float32; on the bf16 route the kernel rounds P to bf16 before P V (the
tensor cores' operand type), and the plain version computes everything in
float32.

The wrapper runs :func:`flash_attention_plain` when every input lies on
the CPU, and otherwise launches the CUDA kernel (``csrc/flash_attention.cu``)
or raises. ``LAUNCHES`` counts kernel launches, and nothing else. No
padding: the kernel masks the ragged edge of Sq and Sk itself. The
wrapper is the roofline walker's kernel scope with
:func:`flash_attention_cost`; under the walker, ``meta`` inputs give an
empty ``meta`` output.
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

NEG_INF = -1e30
MAX_HEAD_DIM = 256
#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES = {"flash_attention": 0}

_LIB: list = []


def _lib():
    if not _LIB:
        lib = build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [PTR] * 5 + [INT] * 7 + [LL] * 12 + [INT] * 2 + [PTR])
        lib.flash_attention_launch.restype = INT
        _LIB.append(lib)
    return _LIB[0]


def flash_attention_plain(q, k, v, *, causal: bool = True, kv_len=None,
                          q_offset: int = 0):
    """What the attention kernels compute, in PyTorch ops (float32).

    q (B, Sq, H, hd); k, v (B, Sk, Hkv, hd); kv_len (B,) ints or None
    (every key valid). Returns (B, Sq, H, hd) in q's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    kpos = torch.arange(Sk, device=q.device)
    valid = torch.ones((B, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        valid = valid & (qpos[:, None] >= kpos[None, :])
    if kv_len is not None:
        valid = valid & (kpos < kv_len.to(q.device)[:, None]
                         )[:, None, None, None, :]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out / l.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def check_attention_args(q, k, v, kv_len, q_offset: int) -> None:
    """Raise on shapes or types the attention kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v (B, Sk, Hkv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len is not None and tuple(kv_len.shape) != (B,):
        raise ValueError(f"kv_len must be ({B},), got {tuple(kv_len.shape)}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a unit stride on its last dim (a copy only if needed):
    the kernels read (B, S, H, hd) tensors through their other strides."""
    return t if t.stride(-1) == 1 else t.contiguous()


def kv_len_ptr(kv_len, dev) -> tuple:
    """(int32 tensor to keep alive, its pointer); (None, None) if absent."""
    if kv_len is None:
        return None, None
    kl = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    return kl, kl.data_ptr()


def _valid_keys(Sq: int, L: int, causal: bool, q_offset: int) -> tuple:
    """(query-key pairs, keys read) that one batch row with ``L`` valid
    keys leaves: query i sees keys j < L, and j <= q_offset + i if
    causal, so min(q_offset + 1 + i, L) of them."""
    if not causal:
        return Sq * L, L
    a = q_offset + 1
    t = max(0, min(Sq, L - a))          # the queries that see fewer than L
    return t * a + t * (t - 1) // 2 + (Sq - t) * L, min(L, q_offset + Sq)


def flash_attention_cost(q, k, v, *, causal: bool = True, kv_len=None,
                         q_offset: int = 0) -> dict:
    """The work attention defines, counting only the (query, key) pairs
    that the causal mask, ``kv_len`` and ``q_offset`` leave valid: per
    pair and head 2 hd FLOPs for q.k and 2 hd for p v, all matmul FLOPs;
    q and the output once, and per batch row only the key and value rows
    some query sees. ``kv_len`` is read from the data (one host read)
    where it can be, and taken as Sk on ``meta`` inputs, where the data is
    not known. bf16 at the tensor cores' rate, float32 at the CUDA
    cores'."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    lens = ([Sk] * B if kv_len is None or walk.is_meta(kv_len)
            else [min(int(n), Sk) for n in kv_len.tolist()])
    pairs = keys = 0
    for L in lens:
        p, n = _valid_keys(Sq, max(L, 0), causal, q_offset)
        pairs, keys = pairs + p, keys + n
    flops = 4 * pairs * H * hd
    kv_bytes = 2 * keys * Hkv * hd * k.element_size()
    rate = (hw.PEAK_FLOPS_BF16 if q.dtype == torch.bfloat16
            else hw.PEAK_FLOPS_F32)
    return rule(flops, 2 * tensor_bytes(q) + kv_bytes
                + tensor_bytes(kv_len), rate, flops)


def _flash_attention_meta(q, k, v, *, causal=True, kv_len=None,
                          q_offset=0):
    check_attention_args(q, k, v, kv_len, q_offset)
    return empty_meta(q.shape, q.dtype)


@walk.kernel("flash_attention", flash_attention_cost, _flash_attention_meta)
def flash_attention(q, k, v, *, causal: bool = True, kv_len=None,
                    q_offset: int = 0):
    """Attention of every query row against the keys, blockwise.

    Arguments and result as :func:`flash_attention_plain`; hd at most
    256.
    """
    check_attention_args(q, k, v, kv_len, q_offset)
    refuse_autograd("flash_attention", q, k, v)
    tensors = (q, k, v) + (() if kv_len is None else (kv_len,))
    if on_cpu(*tensors):
        return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     q_offset=q_offset)
    dev = cuda_device(q)
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    q, k, v = rows(q), rows(k), rows(v)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    kl, kl_ptr = kv_len_ptr(kv_len, dev)  # kl holds the int32 copy alive
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl_ptr, out.data_ptr(),
        B, H, Hkv, Sq, Sk, hd, DTYPE_CODES[q.dtype], *strides, int(causal),
        int(q_offset), stream_ptr(dev))
    raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
