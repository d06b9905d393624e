"""Carry a system and traffic, as numpy arrays, into the port.

This system has no weights: what two implementations must share to be
compared is the machine table and the tasks. These helpers take numpy
arrays (any array with ``__array__``) and build the port's types; they
never import the JAX package, so a caller holding the reference's arrays
converts them with ``numpy.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.policy.context import MachineView, SchedContext
from repro_torch.core.types import Metrics, SystemArrays, SystemSpec, Trace


def system_from_arrays(eet, p_dyn, p_idle, queue_size: int = 2,
                       fairness_factor: float = 1.0) -> SystemSpec:
    """A :class:`SystemSpec` from (S, M) EET and (M,) power arrays."""
    return SystemSpec(
        eet=np.asarray(eet, np.float32),
        p_dyn=np.asarray(p_dyn, np.float32),
        p_idle=np.asarray(p_idle, np.float32),
        queue_size=int(queue_size),
        fairness_factor=float(fairness_factor),
    )


def trace_from_arrays(arrival, task_type, deadline, exec_actual,
                      device=None) -> Trace:
    """A :class:`Trace` on ``device`` (``None`` = CUDA) from one trace's
    arrays ((N,), (N, M)) or a stacked batch's ((..., N), (..., N, M))."""
    dev = resolve_device(device)

    def to(x, dtype):
        return torch.as_tensor(np.array(x, dtype=dtype), device=dev)

    return Trace(
        arrival=to(arrival, np.float32),
        task_type=to(task_type, np.int64),
        deadline=to(deadline, np.float32),
        exec_actual=to(exec_actual, np.float32),
    )


def metrics_to_numpy(metrics: Metrics) -> dict:
    """Metrics as a dict of numpy arrays, under the JAX ``Metrics`` field
    names."""
    return {k: v.detach().cpu().numpy()
            for k, v in metrics._asdict().items()}


def context_from_arrays(*, now, pending, task_type, deadline, avail_base,
                        queue, qlen, eet, p_dyn, p_idle, suffered,
                        device=None) -> SchedContext:
    """A batched :class:`SchedContext` from numpy arrays.

    Per-replicate arrays carry a leading B: ``now`` (B,), ``pending``,
    ``task_type``, ``deadline`` (B, N), ``avail_base``, ``qlen`` (B, M),
    ``queue`` (B, M, Q), ``suffered`` (B, S). ``eet`` (S, M), ``p_dyn``
    and ``p_idle`` (M,) are shared by the batch.
    """
    dev = resolve_device(device)

    def to(x, dtype):
        return torch.as_tensor(np.array(x, dtype=dtype), device=dev)

    return SchedContext(
        now=to(now, np.float32),
        pending=to(pending, np.bool_),
        task_type=to(task_type, np.int64),
        deadline=to(deadline, np.float32),
        view=MachineView(avail_base=to(avail_base, np.float32),
                         queue=to(queue, np.int64), qlen=to(qlen, np.int64)),
        sysarr=SystemArrays(eet=to(eet, np.float32),
                            p_dyn=to(p_dyn, np.float32),
                            p_idle=to(p_idle, np.float32)),
        suffered=to(suffered, np.bool_),
    )
