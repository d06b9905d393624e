"""Carry a system, traffic or model weights, as numpy arrays, into the port.

For the scheduler, what two implementations must share to be compared is
the machine table and the tasks; for the model substrate, the parameter
tree and the optimizer's state. These helpers take numpy arrays (any array with ``__array__``) and
build the port's types; they never import the JAX package, so a caller
holding the reference's arrays converts them with ``numpy.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch import DispatchContext
from repro_torch.core.policy.context import MachineView, SchedContext
from repro_torch.core.types import Metrics, SystemArrays, SystemSpec, Trace


def system_from_arrays(eet, p_dyn, p_idle, queue_size: int = 2,
                       fairness_factor: float = 1.0, site_of_machine=None,
                       tier_of_site=None) -> SystemSpec:
    """A :class:`SystemSpec` from (S, M) EET and (M,) power arrays, and
    optionally an (M,) site partition and (F,) site tiers."""
    return SystemSpec(
        eet=np.asarray(eet, np.float32),
        p_dyn=np.asarray(p_dyn, np.float32),
        p_idle=np.asarray(p_idle, np.float32),
        queue_size=int(queue_size),
        fairness_factor=float(fairness_factor),
        site_of_machine=(None if site_of_machine is None
                         else tuple(int(s) for s in site_of_machine)),
        tier_of_site=(None if tier_of_site is None
                      else tuple(int(t) for t in tier_of_site)),
    )


def _to(device):
    dev = resolve_device(device)

    def to(x, dtype):
        return torch.as_tensor(np.array(x, dtype=dtype), device=dev)

    return to


def trace_from_arrays(arrival, task_type, deadline, exec_actual,
                      device=None) -> Trace:
    """A :class:`Trace` on ``device`` (``None`` = CUDA) from one trace's
    arrays ((N,), (N, M)) or a stacked batch's ((..., N), (..., N, M))."""
    to = _to(device)
    return Trace(
        arrival=to(arrival, np.float32),
        task_type=to(task_type, np.int32),
        deadline=to(deadline, np.float32),
        exec_actual=to(exec_actual, np.float32),
    )


def metrics_to_numpy(metrics: Metrics) -> dict:
    """Metrics as a dict of numpy arrays, under the JAX ``Metrics`` field
    names."""
    return {k: v.detach().cpu().numpy()
            for k, v in metrics._asdict().items()}


def dispatch_context_from_arrays(*, now, unassigned, task_type, deadline,
                                 qlen, running, completed, arrived, eet,
                                 site_of_machine, n_sites: int,
                                 fairness_factor: float = 1.0,
                                 device=None) -> DispatchContext:
    """A batched :class:`DispatchContext` from numpy arrays.

    Per-replicate arrays carry a leading B: ``now`` (B,), ``unassigned``,
    ``task_type``, ``deadline`` (B, N), ``qlen``, ``running`` (B, M),
    ``completed``, ``arrived`` (B, S). ``eet`` (S, M) and the (M,)
    ``site_of_machine`` partition are shared by the batch.
    """
    to = _to(device)
    return DispatchContext(
        now=to(now, np.float32), unassigned=to(unassigned, np.bool_),
        task_type=to(task_type, np.int64), deadline=to(deadline, np.float32),
        qlen=to(qlen, np.int64), running=to(running, np.bool_),
        completed=to(completed, np.int64), arrived=to(arrived, np.int64),
        eet=to(eet, np.float32),
        site_of_machine=to(site_of_machine, np.int64),
        n_sites=int(n_sites), fairness_factor=float(fairness_factor))


def context_from_arrays(*, now, pending, task_type, deadline, avail_base,
                        queue, qlen, eet, p_dyn, p_idle, suffered,
                        device=None) -> SchedContext:
    """A batched :class:`SchedContext` from numpy arrays.

    Per-replicate arrays carry a leading B: ``now`` (B,), ``pending``,
    ``task_type``, ``deadline`` (B, N), ``avail_base``, ``qlen`` (B, M),
    ``queue`` (B, M, Q), ``suffered`` (B, S). ``eet`` (S, M), ``p_dyn``
    and ``p_idle`` (M,) are shared by the batch; ``eet`` (B, S, M) and
    ``p_dyn`` (B, M) give each replicate its own. The types are carried
    both ways the engine carries them: int64 for indexing, int32 for the
    kernels.
    """
    to = _to(device)
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
        task_type32=to(task_type, np.int32),
    )


def _tensor_from_array(a, dtype: torch.dtype, where: str, device):
    """One parameter leaf, bit for bit. A ``bfloat16`` numpy array (the
    ``ml_dtypes`` type JAX hands out) is read as uint16 and reinterpreted,
    so ``ml_dtypes`` is never imported."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        if dtype != torch.bfloat16:
            raise TypeError(f"{where}: bfloat16 array for a {dtype} leaf")
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
        if t.dtype != dtype:
            raise TypeError(f"{where}: {a.dtype} array for a {dtype} leaf")
    return t.to(device)


def model_params_from_arrays(cfg, tree, device=None, mesh=None) -> dict:
    """The port's parameters from the reference's parameter tree.

    ``tree`` is the JAX package's pytree for ``cfg`` as nested dicts of
    numpy arrays (per-layer leaves stacked ``(L, ...)``), for example
    ``jax.tree.map(np.asarray, params)``. Every leaf must be there with
    the port's shape and dtype, and nothing else: a missing or extra key,
    a shape or a dtype that differs raises. Values are carried bit for
    bit, bfloat16 included. Returns nested dicts of tensors on ``device``
    (``None`` = CUDA), or, given a ``DeviceMesh`` (every rank calls it
    with the same arrays), ``DTensor`` s in the reference's layout
    (``distributed.sharding.param_shardings``) on the mesh's device.
    """
    if mesh is None:
        return _params_like(cfg, tree, resolve_device(device), None,
                            "params")
    from repro_torch.distributed import sharding as sh

    params = _params_like(cfg, tree, torch.device("cpu"), None, "params")
    return sh.distribute(params, sh.param_shardings(params, mesh, cfg))


def _params_like(cfg, tree, dev, dtype, root: str) -> dict:
    """``tree`` checked against the parameter tree of ``cfg`` and carried
    onto ``dev``; every leaf of dtype ``dtype`` (``None``: the
    parameter's own)."""
    from repro_torch.models.transformer import param_spec

    def walk(spec, sub, where):
        if not isinstance(spec, dict):
            if tuple(np.shape(sub)) != spec.shape:
                raise ValueError(f"{where}: shape {tuple(np.shape(sub))}, "
                                 f"expected {spec.shape}")
            return _tensor_from_array(sub, dtype or spec.dtype, where, dev)
        if not isinstance(sub, dict):
            raise ValueError(f"{where}: expected a dict of leaves")
        missing = sorted(set(spec) - set(sub))
        extra = sorted(set(sub) - set(spec))
        if missing or extra:
            raise KeyError(f"{where or root}: missing {missing}, "
                           f"extra {extra}")
        return {k: walk(spec[k], sub[k], f"{where}/{k}") for k in spec}

    return walk(param_spec(cfg), tree, "")


def opt_state_from_arrays(cfg, state, device=None, mesh=None):
    """The port's ``AdamWState`` from the reference's.

    ``state`` is the JAX package's ``AdamWState`` for ``cfg``'s parameters
    with numpy leaves (for example ``jax.tree.map(np.asarray, state)``),
    or any object with ``step``, ``mu`` and ``nu``: an int32 scalar and
    two float32 trees shaped like the parameters, checked as
    :func:`model_params_from_arrays` checks those. Values are carried bit
    for bit, onto ``device`` (``None`` = CUDA), or, given a
    ``DeviceMesh``, as ``DTensor`` s in the reference's layout
    (``distributed.sharding.opt_state_shardings``: mu and nu as the
    parameters, the step replicated).
    """
    from repro_torch.optim.adamw import AdamWState

    dev = torch.device("cpu") if mesh is not None else resolve_device(
        device)
    step = np.asarray(state.step)
    if step.shape != () or step.dtype != np.int32:
        raise TypeError(f"step: {step.dtype} {step.shape}, expected an "
                        f"int32 scalar")
    out = AdamWState(
        step=torch.from_numpy(np.array(step)).to(dev),
        mu=_params_like(cfg, state.mu, dev, torch.float32, "mu"),
        nu=_params_like(cfg, state.nu, dev, torch.float32, "nu"))
    if mesh is None:
        return out
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.transformer import param_shapes

    return sh.distribute(out, sh.opt_state_shardings(param_shapes(cfg),
                                                     mesh, cfg))
