"""int8 error-feedback gradient compression for the cross-pod all-reduce
(counterpart of ``repro/distributed/compression.py``).

At 2+ pods the gradient all-reduce crosses the slow inter-pod links.
Each tensor is compressed to int8 under a dynamic scale and the
quantization residual stays local (error feedback), which preserves
convergence (Karimireddy et al. 2019 style). Intra-pod reduction stays
float32. The arithmetic is the reference's, in its order:
``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import map_path


def quantize_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _unzip(out, n: int):
    """A tree of n-tuples (leaves for ``map_path``) -> n trees."""
    return tuple(map_path(lambda _, t: t[i], out) for i in range(n))


def compress_tree(grads, residuals):
    """-> (quantized tree, scales tree, new residuals)."""
    def one(_, g, r):
        g32 = g.to(torch.float32) + r
        q, s = quantize_int8(g32)
        return q, s, g32 - dequantize_int8(q, s)

    return _unzip(map_path(one, grads, residuals), 3)


def init_residuals(params):
    return map_path(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def crosspod_mean_compressed(grads, residuals, group=None):
    """Error-feedback int8 mean of ``grads`` over the ranks of ``group``
    (the ``pod`` mesh dim's: ``mesh.get_group("pod")``; ``None``: the
    default group). Every rank calls it with its own gradients and
    residuals; returns (mean gradients in their dtypes, new residuals).

    Per tensor: the shared scale is the MAX over ranks of each rank's
    ``max|g32| / 127`` (one tiny float32 all-reduce), so every rank's
    int8 payload dequantizes exactly; the payload is summed as int32.
    """
    n = dist.get_world_size(group)

    def one(_, g, r):
        g32 = g.to(torch.float32) + r
        s = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
        new_r = g32 - q.to(torch.float32) * s
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.to(torch.float32) * s / n).to(g.dtype), new_r

    return _unzip(map_path(one, grads, residuals), 2)

