"""The arguments with which a cell's event loop calls each kernel, as
``meta`` tensors: the shapes and types the cost rules count.

``B`` replicates of ``N`` tasks on ``M`` machines of ``S`` task types in
``F`` sites of equal contiguous machine blocks. A federation's map
stage runs over ``B * F`` site rows of ``M / F`` machines, with one EET
table and power row per site row; the flat system's rows share one
(S, M) table and power row. The dispatcher's walk runs over the ``B``
replicates and their ``F`` sites.
"""
from __future__ import annotations

import torch

f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool


def _t(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def kernel_args(kernel: str, B: int, N: int, M: int, S: int, F: int = 1):
    """The ``meta`` argument tuple of one launch of ``kernel``."""
    if F > 1:
        R, m = B * F, M // F
        eet, p_dyn = _t((R, S, m), f32), _t((R, m), f32)
    else:
        R, m = B, M
        eet, p_dyn = _t((S, M), f32), _t((M,), f32)
    if kernel == "map_decide":
        return (_t((R,), f32), _t((R, m), f32), p_dyn, _t((R, m), b8), eet,
                _t((R, N), f32), _t((R, N), b8), _t((R, N), i32),
                _t((R, N), b8))
    if kernel == "evict_stats":
        return (_t((R, m), f32), _t((R, m), b8), eet, _t((R, N), f32),
                _t((R, N), b8), _t((R, N), i32))
    if kernel == "phase1_map":
        return (_t((R, m), f32), _t((R, N, m), f32), _t((R, N), f32), p_dyn,
                _t((R, N), b8), _t((R, m), b8))
    if kernel == "balance_scan":
        return (_t((B, F), i64), _t((B, N), b8), _t((B, N), b8),
                _t((B, N), i64))
    raise ValueError(f"no shapes for kernel {kernel!r}")


def input_bytes(args) -> int:
    """Bytes of a launch's inputs."""
    return sum(a.numel() * a.element_size() for a in args)
