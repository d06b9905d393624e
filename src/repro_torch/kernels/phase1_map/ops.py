"""ELARE Phase I as one kernel: wrapper and plain version.

Counterpart of ``repro/kernels/phase1_map/{kernel,ops,ref}.py``, batched
over B replicates. The contract is the JAX hook's
(``MinEnergyFeasible.impl``)::

    phase1_map(avail, eet_rows, deadline, p_dyn, pending, qfree)
        -> (best_m (B, N) int64, best_ec (B, N) f32 — BIG when infeasible)

with ``avail`` (B, M) f32 start times, ``eet_rows`` (B, N, M) f32
pre-gathered EET rows, ``deadline`` (B, N) f32, ``p_dyn`` (M,) or (B, M)
f32, ``pending`` (B, N) bool and ``qfree`` (B, M) bool.

The wrapper runs the plain version when every input lies on the CPU and
otherwise launches ``csrc/phase1_map.cu`` or raises. ``LAUNCHES`` counts
kernel launches. It is the roofline walker's kernel scope with
:func:`phase1_map_cost`; under the walker, ``meta`` inputs give empty
``meta`` outputs.
"""
from __future__ import annotations

import torch

from repro_torch.core.equations import BIG
from repro_torch.kernels import build
from repro_torch.kernels.common import (
    INT,
    PTR,
    check,
    cuda_device,
    empty_meta,
    on_cpu,
    raise_on,
    rule,
    stream_ptr,
    tensor_bytes,
)
from repro_torch.roofline import hw, walk

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES = {"phase1_map": 0}

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("phase1_map")
        lib.phase1_map_launch.argtypes = [PTR] * 2 + [INT] + [PTR] * 6 + \
            [INT] * 3 + [PTR]
        lib.phase1_map_launch.restype = INT
        _LIB = lib
    return _LIB


def phase1_map_plain(avail, eet_rows, deadline, p_dyn, pending, qfree):
    """What the ``phase1_map`` kernel computes, in PyTorch ops."""
    pd = p_dyn if p_dyn.dim() == 2 else p_dyn[None, :]
    feas = ((avail[:, None, :] + eet_rows <= deadline[:, :, None])
            & pending[:, :, None] & qfree[:, None, :])
    ec = torch.where(feas, pd[:, None, :] * eet_rows,
                     torch.full((), BIG, device=eet_rows.device))
    best_ec, best_m = ec.min(dim=2)
    return best_m, best_ec


def phase1_map_cost(avail, eet_rows, deadline, p_dyn, pending,
                    qfree) -> dict:
    """Every input read once, ``best_m`` (int64) and ``best_ec`` (float32)
    written once; per task and machine three float32 operations (Eq. 1's
    sum, the energy product, the minimum)."""
    B, N, M = eet_rows.shape
    return rule(B * N * 3 * M,
                tensor_bytes(avail, eet_rows, deadline, p_dyn, pending,
                             qfree) + B * N * (8 + 4),
                hw.PEAK_FLOPS_F32)


def _phase1_map_meta(avail, eet_rows, *_a):
    B, N, _ = eet_rows.shape
    return empty_meta((B, N), torch.int64), empty_meta((B, N), torch.float32)


@walk.kernel("phase1_map", phase1_map_cost, _phase1_map_meta)
def phase1_map(avail, eet_rows, deadline, p_dyn, pending, qfree):
    """Per task: the feasible machine of least energy, and that energy."""
    args = (avail, eet_rows, deadline, p_dyn, pending, qfree)
    if on_cpu(*args):
        return phase1_map_plain(*args)
    dev = cuda_device(eet_rows)
    B, N, M = eet_rows.shape
    pdyn_shape = (M,) if p_dyn.dim() == 1 else (B, M)
    ptrs = [
        check(avail, "avail", torch.float32, (B, M), dev),
        check(p_dyn, "p_dyn", torch.float32, pdyn_shape, dev),
        check(qfree, "qfree", torch.bool, (B, M), dev),
        check(eet_rows, "eet_rows", torch.float32, (B, N, M), dev),
        check(deadline, "deadline", torch.float32, (B, N), dev),
        check(pending, "pending", torch.bool, (B, N), dev),
    ]
    best_m = torch.empty((B, N), dtype=torch.int64, device=dev)
    best_ec = torch.empty((B, N), dtype=torch.float32, device=dev)
    rc = _lib().phase1_map_launch(
        ptrs[0], ptrs[1], 0 if p_dyn.dim() == 1 else M, *ptrs[2:],
        best_m.data_ptr(), best_ec.data_ptr(), B, N, M, stream_ptr(dev))
    raise_on(rc, "phase1_map")
    LAUNCHES["phase1_map"] += 1
    return best_m, best_ec
