"""Single-token decode attention: the wrapper and its plain version.

Counterpart of ``repro/kernels/decode_attention`` (``ops.decode_attention``
over the TPU kernel ``decode_attention_bhd``): one query row per (batch,
head) against a KV cache, q (B, 1, H, hd), k and v (B, Sk, Hkv, hd),
``kv_len`` (B,) valid cache rows, in the model layout; the result is
(B, 1, H, hd) in q's dtype. The semantics are the TPU kernel's (see
``flash_attention/ops.py``): scale before the product, ``-1e30`` for a
key at or past ``kv_len``, ``max(l, 1e-30)``, float32 throughout.

The wrapper runs :func:`decode_attention_plain` when every input lies on
the CPU, and otherwise launches the CUDA kernel
(``csrc/decode_attention.cu``) or raises. ``LAUNCHES`` counts kernel
launches, and nothing else. The wrapper is the roofline walker's kernel
scope with :func:`decode_attention_cost`; under the walker, ``meta``
inputs give an empty ``meta`` output.
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
    stream_ptr,
)
from repro_torch.kernels.flash_attention.ops import (
    check_attention_args,
    flash_attention_cost,
    flash_attention_plain,
    kv_len_ptr,
    rows,
)
from repro_torch.roofline import walk

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES = {"decode_attention": 0}

_LIB: list = []


def _lib():
    if not _LIB:
        lib = build.load("decode_attention")
        lib.decode_attention_launch.argtypes = (
            [PTR] * 5 + [INT] * 6 + [LL] * 12 + [PTR])
        lib.decode_attention_launch.restype = INT
        _LIB.append(lib)
    return _LIB[0]


def decode_attention_plain(q, k, v, kv_len):
    """The plain version of :func:`decode_attention`."""
    return flash_attention_plain(q, k, v, causal=False, kv_len=kv_len)


def decode_attention_cost(q, k, v, kv_len) -> dict:
    """:func:`decode_attention`'s cost: one query row against the first
    ``kv_len`` rows (:func:`flash_attention.ops.flash_attention_cost`,
    not causal)."""
    return flash_attention_cost(q, k, v, causal=False, kv_len=kv_len)


def _decode_attention_meta(q, k, v, kv_len):
    check_attention_args(q, k, v, kv_len, 0)
    return empty_meta(q.shape, q.dtype)


@walk.kernel("decode_attention", decode_attention_cost,
             _decode_attention_meta)
def decode_attention(q, k, v, kv_len):
    """One query row per (batch, head) against the first ``kv_len`` rows
    of the cache. Arguments and result as :func:`decode_attention_plain`;
    hd at most 256."""
    check_attention_args(q, k, v, kv_len, 0)
    if q.shape[1] != 1 or kv_len is None:
        raise ValueError(f"decode takes q (B, 1, H, hd) and kv_len, got q "
                         f"{tuple(q.shape)}")
    refuse_autograd("decode_attention", q, k, v)
    if on_cpu(q, k, v, kv_len):
        return decode_attention_plain(q, k, v, kv_len)
    dev = cuda_device(q)
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    q, k, v = rows(q), rows(k), rows(v)
    B, _, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    kl, kl_ptr = kv_len_ptr(kv_len, dev)  # kl holds the int32 copy alive
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl_ptr, out.data_ptr(),
        B, H, Hkv, Sk, hd, DTYPE_CODES[q.dtype], *strides, stream_ptr(dev))
    raise_on(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
