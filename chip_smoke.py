#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FELARE simulator on one CUDA card.

    python3 chip_smoke.py            # the full check, on one card
    python3 chip_smoke.py --reps 10  # a shorter main path

Phases, one JSON line each; any failed check raises, so the script exits
non-zero and prints no result line:

  1. env      torch and CUDA versions, the card's name and power limit;
  2. build    nvcc builds the kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels  each kernel against its plain PyTorch version on the card,
              bit for bit (``torch.equal`` on every output), at the main
              path's shape and at a wide one, over every nominator x key x
              drop rule with the suffered split on and off;
  4. main     the paper-scale sweep (paper 4x4 system, rates 2-8, 30
              replicates of 2000 tasks) with ELARE, FELARE and MM on the
              fused map kernels and ELARE on the phase1_map kernel; the
              launch counts, zeroed just before, must show every kernel
              ran on every batched event;
  5. parity   the same traces through the plain path on the card give
              identical counters and makespans, and a 2 x 2 subset
              through the port on the CPU gives identical counters with
              energies within rel 1e-5 (sums over machines run in another
              order there);
  6. profile  where one batched event's time goes: the first 64
              iterations of the fused FELARE sweep under torch.profiler
              (wall vs device-busy time, kernels per iteration);
  7. times    per kernel at the main path's shape: device time per
              launch (``torch.profiler``), the plain version's device time
              per call, the eager time per call by CUDA events with the
              host's work included, and the least time the card could
              take for the same bytes and operations.

Then the card's name and power limit as ``nvidia-smi`` prints them, one
``{"kernels": [...]}`` line, and the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
MAIN_SHAPE = dict(B=150, N=2000, M=4, S=4)
WIDE_SHAPE = dict(B=8, N=10_000, M=512, S=8)
RATES = (2.0, 3.0, 4.0, 6.0, 8.0)
KERNEL_SOURCES = {
    "map_decide": ("src/repro_torch/kernels/csrc/map_fused.cu",
                   "src/repro/kernels/map_fused/kernel.py:181"),
    "evict_stats": ("src/repro_torch/kernels/csrc/map_fused.cu",
                    "src/repro/kernels/map_fused/kernel.py:237"),
    "phase1_map": ("src/repro_torch/kernels/csrc/phase1_map.cu",
                   "src/repro/kernels/phase1_map/kernel.py:42"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Kernel inputs: random, with forced ties, negative urgency keys, full
# queues and stale tasks.
# --------------------------------------------------------------------------
def kernel_inputs(B, N, M, S, seed, device):
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    f32 = np.float32
    eet = np.round(r.uniform(0.5, 5.0, (S, M)) * 8) / 8
    if M > 1:
        eet[:, 1] = eet[:, 0]                          # duplicate columns
    now = np.round(r.uniform(0.0, 50.0, B) * 4) / 4
    start = now[:, None] + r.choice([0.0, 0.5, 1.0, 2.5], (B, M))
    deadline = now[:, None] + r.choice(np.arange(-4.0, 12.0, 0.5), (B, N))
    qfree = r.random((B, M)) < 0.7
    qfree[0] = False                                   # one replicate full
    arrays = dict(
        now=now.astype(f32), start=start.astype(f32),
        p_dyn=r.choice([1.5, 1.6, 3.0], M).astype(f32), qfree=qfree,
        eet=eet.astype(f32), deadline=deadline.astype(f32),
        pending=r.random((B, N)) < 0.8,
        task_type=r.integers(0, S, (B, N)).astype(np.int64),
        suffered=r.random((B, N)) < 0.3,
    )
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def map_decide_args(x):
    return (x["now"], x["start"], x["p_dyn"], x["qfree"], x["eet"],
            x["deadline"], x["pending"], x["task_type"])


def evict_stats_args(x):
    return (x["start"], x["qfree"], x["eet"], x["deadline"], x["pending"],
            x["task_type"])


def phase1_args(x):
    return (x["start"], x["eet"][x["task_type"]].contiguous(),
            x["deadline"], x["p_dyn"], x["pending"], x["qfree"])


def compare(outs_k, outs_p, what: str) -> float:
    """Raise unless every output is equal; return the max abs error."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        require(torch.equal(a, b), f"{what}: output {i} differs from plain")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def check_kernels(device) -> dict:
    """Every kernel against its plain version on the card, bit for bit."""
    import torch

    from repro_torch.kernels import map_fused, phase1_map
    from repro_torch.kernels.map_fused import ops as mf

    errs = {k: 0.0 for k in KERNEL_SOURCES}
    cases = 0
    for label, shape in (("main", MAIN_SHAPE), ("wide", WIDE_SHAPE)):
        x = kernel_inputs(**shape, seed=11, device=device)
        for nom in mf.NOMINATOR_KINDS:
            for key in mf.KEY_KINDS:
                for drop in mf.DROP_KINDS:
                    for suff in (x["suffered"],
                                 torch.zeros_like(x["suffered"])):
                        kw = dict(nominator=nom, phase2_key=key,
                                  drop_rule=drop)
                        out_k = map_fused.map_decide(*map_decide_args(x),
                                                     suff, **kw)
                        torch.cuda.synchronize()
                        out_p = map_fused.map_decide_plain(
                            *map_decide_args(x), suff, **kw)
                        errs["map_decide"] = max(errs["map_decide"], compare(
                            out_k, out_p, f"map_decide {label} {kw}"))
                        cases += 1
        out_k = map_fused.evict_stats(*evict_stats_args(x))
        torch.cuda.synchronize()
        errs["evict_stats"] = max(errs["evict_stats"], compare(
            out_k, map_fused.evict_stats_plain(*evict_stats_args(x)),
            f"evict_stats {label}"))
        out_k = phase1_map.phase1_map(*phase1_args(x))
        torch.cuda.synchronize()
        errs["phase1_map"] = max(errs["phase1_map"], compare(
            out_k, phase1_map.phase1_map_plain(*phase1_args(x)),
            f"phase1_map {label}"))
        cases += 2
        emit("kernels", shape=label, **shape, cases=cases, equal=True)
    return errs


# --------------------------------------------------------------------------
# Main path and its parity
# --------------------------------------------------------------------------
def reset_counts():
    from repro_torch.core import engine
    from repro_torch.kernels.map_fused import ops as mf
    from repro_torch.kernels.phase1_map import ops as p1

    for d in (mf.LAUNCHES, p1.LAUNCHES, engine.COUNTS):
        for k in d:
            d[k] = 0


def read_counts() -> dict:
    from repro_torch.kernels.map_fused import ops as mf
    from repro_torch.kernels.phase1_map import ops as p1

    return {**mf.LAUNCHES, **p1.LAUNCHES}


def summarize(result, run_name: str) -> None:
    import numpy as np

    m = result.metrics
    n_tasks = result.spec.n_tasks
    total = (m.completed_by_type + m.missed_by_type
             + m.cancelled_by_type).sum(-1)
    require(bool(np.all(total == n_tasks))
            and bool(np.all(m.arrived_by_type.sum(-1) == n_tasks)),
            f"{run_name}: tasks not conserved")
    for leaf in (m.energy_dynamic, m.energy_wasted, m.energy_idle,
                 m.makespan):
        require(bool(np.all(np.isfinite(leaf))), f"{run_name}: non-finite")
    for h_i, h in enumerate(result.heuristics):
        info = result.run_info[h]
        emit("main", run=run_name, heuristic=h, seconds=info["seconds"],
             event_steps=info["loop_iterations"],
             rates=list(result.rates),
             completion_rate=[float(v) for v in result.completion_rate[h_i]],
             worst_type_rate=[float(v) for v in result.worst_type_rate[h_i]],
             wasted_pct=[float(v) for v in result.wasted_pct[h_i]])


def same_counts(a, b, what: str, energy_rel=None) -> None:
    import numpy as np

    for k in ("completed_by_type", "missed_by_type", "cancelled_by_type",
              "arrived_by_type"):
        require(np.array_equal(getattr(a, k), getattr(b, k)),
                f"{what}: {k} differs")
    if energy_rel is None:
        require(np.array_equal(a.makespan, b.makespan),
                f"{what}: makespan differs")
        return
    for k in ("energy_dynamic", "energy_wasted", "energy_idle", "makespan"):
        x = np.asarray(getattr(a, k), np.float64)
        y = np.asarray(getattr(b, k), np.float64)
        rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-30)
        require(bool(np.all(rel <= energy_rel)),
                f"{what}: {k} off by rel {float(rel.max())}")


def run_main_path(device, reps: int, n_tasks: int) -> dict:
    import numpy as np

    from repro_torch import scenarios
    from repro_torch.core import api
    from repro_torch.core.types import Metrics, Trace
    from repro_torch.experiments import SweepSpec, run_sweep

    system = api.paper_system()
    traces = scenarios.DEFAULT.stack(0, RATES, reps, n_tasks, system.eet,
                                     device=device)
    fused = SweepSpec(system="paper", rates=RATES, reps=reps,
                      n_tasks=n_tasks, heuristics=("ELARE", "FELARE", "MM"),
                      seed=0, use_fused_map=True)
    phase1 = SweepSpec(system="paper", rates=RATES, reps=reps,
                       n_tasks=n_tasks, heuristics=("ELARE",), seed=0,
                       use_fused_phase1=True)

    reset_counts()
    res_fused = run_sweep(fused, traces=traces, device=device)
    res_p1 = run_sweep(phase1, traces=traces, device=device)
    counts = read_counts()
    summarize(res_fused, "fused_map")
    summarize(res_p1, "fused_phase1")
    steps = {h: res_fused.run_info[h]["loop_iterations"]
             for h in fused.heuristics}
    expect = {"map_decide": sum(steps.values()),
              "evict_stats": steps["FELARE"],
              "phase1_map": res_p1.run_info["ELARE"]["loop_iterations"]}
    emit("main", launches=counts, expected=expect)
    for k, v in expect.items():
        require(v > 0 and counts[k] == v,
                f"{k}: {counts[k]} launches, {v} batched events")

    # -- parity: plain path on the card, same traces ----------------------
    plain = run_sweep(SweepSpec(system="paper", rates=RATES, reps=reps,
                                n_tasks=n_tasks,
                                heuristics=fused.heuristics, seed=0),
                      traces=traces, device=device)
    same_counts(res_fused.metrics, plain.metrics, "fused vs plain (card)")
    same_counts(res_p1.metrics, Metrics(*(x[:1] for x in plain.metrics)),
                "phase1 vs plain (card)")

    # -- parity: a 2 x 2 subset through the port on the CPU ----------------
    sub = Trace(*(x[:2, :2].cpu() for x in traces))
    cpu = run_sweep(SweepSpec(system="paper", rates=RATES[:2], reps=2,
                              n_tasks=n_tasks, heuristics=fused.heuristics,
                              seed=0, use_fused_map=True),
                    traces=sub, device="cpu")
    card_sub = Metrics(*(x[:, :2, :2] for x in res_fused.metrics))
    same_counts(cpu.metrics, card_sub, "card vs CPU subset", energy_rel=1e-5)
    emit("parity", plain_on_card="identical counters and makespans",
         cpu_subset="identical counters, energies within rel 1e-5",
         plain_seconds={h: plain.run_info[h]["seconds"]
                        for h in plain.heuristics},
         cpu_cells=int(np.prod(cpu.metrics.makespan.shape)))
    return counts


def profile_main_path(device, reps: int, n_tasks: int, steps: int = 64):
    """Where the time of one batched event goes: the first ``steps``
    iterations of the fused FELARE and the phase1 ELARE sweeps under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import scenarios
    from repro_torch.core import api, engine, policy

    system = api.paper_system()
    traces = scenarios.DEFAULT.stack(0, RATES, reps, n_tasks, system.eet,
                                     device=device)
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    for label, pol in (("FELARE fused_map",
                        policy.with_fused_map("FELARE")),
                       ("ELARE fused_phase1",
                        policy.with_fused_phase1("ELARE"))):
        sim = engine.make_simulator(
            pol, system.as_torch(device), queue_size=system.queue_size,
            max_steps=steps)
        sim(flat)                                        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim(flat)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim(flat)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        emit("profile", run=label, replicates=int(flat.arrival.shape[0]),
             iterations=steps,
             wall_ms_per_iteration=wall_plain * 1e3 / steps,
             wall_ms_per_iteration_profiled=wall * 1e3 / steps,
             device_busy_ms_per_iteration=busy_us * 1e-3 / steps,
             device_idle_share=1.0 - busy_us * 1e-6 / wall_plain,
             kernels_per_iteration=sum(e.count for e in kernels) / steps,
             top_kernels=[{"name": e.key[:60],
                           "us_per_launch": e.self_device_time_total
                           / e.count, "launches": e.count} for e in top],
             ours_us_per_launch={
                 name: next((e.self_device_time_total / e.count
                             for e in kernels if f"{name}_kernel" in e.key),
                            None)
                 for name in KERNEL_SOURCES})


# --------------------------------------------------------------------------
# Times
# --------------------------------------------------------------------------
def time_ms(fn, iters: int) -> float:
    """Eager time per call by CUDA events: launches issued one after
    another from the host, so the host's own work per call shows."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call: the summed time of every kernel ``fn``
    launches, from ``torch.profiler`` over ``iters`` calls after warm-up
    (host work between launches does not count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0)
    require(busy_us > 0, "the profiler saw no device time")
    return busy_us * 1e-3 / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_kernels(device, launches: dict, errs: dict) -> list:
    import torch

    from repro_torch.kernels import map_fused, phase1_map

    x = kernel_inputs(**MAIN_SHAPE, seed=5, device=device)
    B, N, M = MAIN_SHAPE["B"], MAIN_SHAPE["N"], MAIN_SHAPE["M"]
    kinds = dict(nominator="min_energy_feasible", phase2_key="value",
                 drop_rule="stale_hopeless")          # FELARE's kinds
    md_args = map_decide_args(x) + (x["suffered"],)
    es_args = evict_stats_args(x)
    p1_args = phase1_args(x)
    table = {
        # name: (kernel call, plain call, bytes moved, float operations)
        "map_decide": (
            lambda: map_fused.map_decide(*md_args, **kinds),
            lambda: map_fused.map_decide_plain(*md_args, **kinds),
            nbytes(*md_args, *map_fused.map_decide(*md_args, **kinds)),
            B * N * (4 * M + 2)),
        "evict_stats": (
            lambda: map_fused.evict_stats(*es_args),
            lambda: map_fused.evict_stats_plain(*es_args),
            nbytes(*es_args, *map_fused.evict_stats(*es_args)),
            B * N * 3 * M),
        "phase1_map": (
            lambda: phase1_map.phase1_map(*p1_args),
            lambda: phase1_map.phase1_map_plain(*p1_args),
            nbytes(*p1_args, *phase1_map.phase1_map(*p1_args)),
            B * N * 3 * M),
    }
    rows = []
    for name, (kern, plain, moved, ops) in table.items():
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": device_ms(kern, 100), "plain_ms": device_ms(plain, 20),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        emit("times", kernel=name, bytes=moved, operations=ops,
             eager_ms=time_ms(kern, 200), eager_plain_ms=time_ms(plain, 50),
             **{k: rows[-1][k] for k in ("ms", "plain_ms", "bound_ms")})
    torch.cuda.synchronize()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30,
                    help="replicates per rate on the main path (default 30)")
    ap.add_argument("--tasks", type=int, default=2000,
                    help="tasks per trace on the main path (default 2000)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build  # fails outside a checkout

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=torch.cuda.get_device_name(0),
         nvidia_smi=smi, device_count=torch.cuda.device_count())

    t_build = time.perf_counter()
    logs = build.build(verbose=True)
    regs = {k: sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in v["log"].splitlines() if "registers" in ln})
            for k, v in logs.items()}
    emit("build", wall_seconds=time.perf_counter() - t_build,
         seconds={k: v["seconds"] for k, v in logs.items()},
         registers_per_thread={k: [r[0], r[-1]] for k, r in regs.items()})

    errs = check_kernels(device)
    if args.reps != 30 or args.tasks != 2000:
        emit("cut", reps=args.reps, tasks=args.tasks,
             note="main path run below paper scale (30 reps x 2000 tasks)")
    launches = run_main_path(device, args.reps, args.tasks)
    profile_main_path(device, args.reps, args.tasks)
    rows = time_kernels(device, launches, errs)
    emit("done", seconds=time.perf_counter() - t_start)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
