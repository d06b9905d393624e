"""Batched Monte-Carlo sweep execution (counterpart of
``repro/experiments/runner.py``).

One sweep is one trace stack, (rates x replicates) flattened to a batch
of B traces, simulated as one batch per heuristic: every heuristic sees
the same traces.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.core import engine, observe, spans
from repro_torch.core.device import resolve_device
from repro_torch.core.types import SystemSpec, Trace
from repro_torch.distributed import sharding
from repro_torch.experiments.results import SweepResult
from repro_torch.experiments.spec import SweepSpec


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.array(x))


def simulate_sweep(traces: Trace, system: SystemSpec, heuristic_names, *,
                   dispatcher=None, dynamics=None, network=None,
                   use_fused_phase1: bool = False,
                   use_fused_map: bool = False, max_steps=None, device=None,
                   observers=(), run_info: dict | None = None,
                   trace_label: str = ""):
    """Simulate a flat batch of traces (leaves (B, N), (B, N, M)) under
    every heuristic, on ``device`` (``None`` = CUDA). A federated
    ``system`` dispatches through ``dispatcher`` (``None`` = ``sticky``);
    ``use_fused_map`` also puts its balance walk on the kernel.
    ``dynamics`` (a registered name or instance; ``None`` = ``"none"``)
    injects machine failures; every heuristic sees the same ones.
    ``network`` (a registered name or instance; ``None`` = ``"none"``)
    prices each dispatch's link over ``system.tier_of_site``.

    Returns Metrics as numpy arrays with leaves (H, B, ...), or
    ``(Metrics, aux)`` with ``observers`` attached, every aux leaf a
    numpy array (H, B, ...). When ``run_info`` is a dict, it receives
    per heuristic the wall seconds, the number of batched loop
    iterations and ``trace_label`` (``run_sweep`` passes the scenario's
    name). On a CUDA device the simulation runs with that device current,
    so the kernels' launchers find their streams on it.
    """
    dev = resolve_device(device)
    per_h = []
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        for name in heuristic_names:
            t0 = time.perf_counter()
            it0 = engine.COUNTS["loop_iterations"]
            with spans.span("sweep.simulate", heuristic=name):
                out = engine.simulate_batch(
                    traces, system, name, observers=observers,
                    max_steps=max_steps, dispatcher=dispatcher,
                    dynamics=dynamics, network=network,
                    use_fused_map=use_fused_map,
                    use_fused_phase1=use_fused_phase1, device=dev)
                rec = spans.current()
                if rec is not None and dev.type == "cuda":
                    # so that sweep.to_host holds the copy alone
                    with rec.span("sweep.drain"):
                        torch.cuda.synchronize(dev)
                with spans.span("sweep.to_host"):
                    per_h.append(observe.tree_map(
                        lambda x: x.cpu().numpy(), out))
                if rec is not None:
                    rec.resolve()
            if run_info is not None:
                run_info[name] = {
                    "seconds": time.perf_counter() - t0,
                    "loop_iterations": (engine.COUNTS["loop_iterations"]
                                        - it0),
                    "scenario": trace_label,
                }
    return observe.tree_map(lambda *xs: np.stack(xs), *per_h)


def _simulate_sharded(flat: Trace, devices, **kw):
    """``simulate_sweep`` of the flat batch split over ``devices``: the
    batch padded to a multiple of their count (padding repeats trace 0),
    each slice simulated on its own device in turn, the results joined
    on the batch axis and the padding sliced off (each slice with its
    device current, ``simulate_sweep``). The traces are independent, so
    the result is the unsharded one bit for bit."""
    run_info = kw.pop("run_info", None)
    B = flat.arrival.shape[0]
    padded = sharding.pad_batch(flat, len(devices))
    n = padded.arrival.shape[0] // len(devices)
    outs, infos = [], []
    for i, dev in enumerate(devices):
        part = Trace(*(x[i * n:(i + 1) * n].to(dev) for x in padded))
        info: dict = {}
        outs.append(simulate_sweep(part, device=dev, run_info=info, **kw))
        infos.append(info)
    if run_info is not None:
        for name in infos[0]:
            run_info[name] = {
                "seconds": sum(i[name]["seconds"] for i in infos),
                "loop_iterations": sum(i[name]["loop_iterations"]
                                       for i in infos),
                "scenario": infos[0][name]["scenario"]}
    return observe.tree_map(
        lambda *xs: np.concatenate(xs, axis=1)[:, :B], *outs)


def run_sweep(spec: SweepSpec, *, traces: Trace | None = None,
              device=None, shard: bool = False) -> SweepResult:
    """Execute a full batched sweep on ``device`` (``None`` = CUDA).

    Builds the (rates x reps) trace stack of the spec's scenario from
    ``spec.seed``, with the resolved system's task types — or takes
    ``traces``, any stack whose leaves lead with (R, K) (numpy arrays or
    tensors, e.g. the reference's own ``trace_stack``) — simulates it
    under every heuristic and wraps the per-trace Metrics and the
    observers' results, reshaped to (H, R, K, ...), in a
    :class:`SweepResult`.

    ``shard=True`` splits the (R*K) trace batch over every visible CUDA
    device (``distributed.sharding.sweep_devices``), one slice per
    device: an execution detail, not part of the spec. Results are
    bit-identical to the unsharded sweep, and with one device it is the
    plain path, so a spec stays reproducible whatever the topology.
    """
    with spans.span("sweep"):
        return _run_sweep(spec, traces, resolve_device(device), shard)


def _run_sweep(spec, traces, dev, shard) -> SweepResult:
    system = spec.resolve_system()
    R, K = len(spec.rates), spec.reps
    if traces is None:
        traces = spec.resolve_scenario().stack(
            spec.seed, spec.rates, spec.reps, spec.n_tasks, system.eet,
            cv_run=spec.cv_run, n_task_types=system.n_task_types,
            device=dev)
    flat = Trace(*(_as_tensor(x).reshape((R * K,) + tuple(x.shape[2:]))
                   for x in traces))
    run_info: dict = {}
    observers = spec.resolve_observers()
    kw = dict(
        system=system, heuristic_names=spec.heuristics,
        dispatcher=spec.dispatcher,
        dynamics=spec.resolve_dynamics(), network=spec.resolve_network(),
        use_fused_phase1=spec.use_fused_phase1,
        use_fused_map=spec.use_fused_map, max_steps=spec.max_steps,
        observers=observers, run_info=run_info,
        trace_label=(spec.scenario if isinstance(spec.scenario, str)
                     else "<custom scenario>"))
    devices = sharding.sweep_devices(dev) if shard else None
    if devices is None:
        out = simulate_sweep(flat, device=dev, **kw)
    else:
        out = _simulate_sharded(flat, devices, **kw)
    metrics, aux = out if observers else (out, {})
    H = len(spec.heuristics)
    with spans.span("sweep.wrap"):
        metrics, aux = observe.tree_map(
            lambda x: x.reshape((H, R, K) + x.shape[2:]), (metrics, aux))
        return SweepResult.from_metrics(spec, system, metrics, aux=aux,
                                        device=str(dev), run_info=run_info)
