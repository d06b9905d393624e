"""One run of one cell: set-up, the measured window of whole sweep
batches, the traced window (``--trace 1``), the check, the result line.

The entry the window drives is the program's
``repro_torch.experiments.runner.run_sweep`` on the card, with the
cell's system, heuristic, dispatcher and kernel route, fed the
benchmark's own traces (``portbench/traffic.py``). A batch is one trace
stack of rates x replicates x tasks under the cell's heuristic, drawn
from ``(seed, batch index)``; it is timed from its traces' generation to
its results on the host as numpy. Batches run back to back until
``--seconds`` have passed; the batch in progress finishes and counts.

With ``--trace 1`` the measured window runs as it does untraced, and
then batch 0's traces are simulated once more under ``torch.profiler``
(device records only): the traced window is the mix's ``trace_steps``
whole loop iterations after the first ``TRACE_SKIP``, so the
simulation's own set-up stays out of it, and the card is synchronised
at both ends of it. The profiler comes last because the launches that
follow it in the same process run slower. Its count of each of the
program's kernels has to equal the program's own count of its launches
(``LAUNCHES``) over the window, or the run fails: records were dropped.
The per-layer metrics that ``portbench/metrics/<name>.py`` read from
both windows are reported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np

from portbench import cells, compare, traffic
from portbench.reference import sim

#: Top-level modules that may not be loaded in the process that reports.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The batch index of the warm-up's traces (never a window batch).
WARM_BATCH = 2**40
#: Loop iterations of the traced simulation before its traced window.
TRACE_SKIP = 64
#: The program's kernels whose profiler records are counted against
#: its own launch counters.
KERNELS = ("map_decide", "evict_stats", "balance_scan", "phase1_map")
SRC = cells.ROOT / "src"
CACHE = cells.ROOT / "build" / "portbench_cache"


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=(
        "Run one cell of the port's benchmark once and print its result "
        "line."))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_system(cfg: dict, system) -> None:
    """The port's resolved system has to be the configuration file's
    deployment: EET, powers, queue size, fairness factor, sites."""
    want = sim.System(cfg)
    got_sites = np.asarray(system.sites, np.int64)
    problems = [name for name, a, b in (
        ("eet", np.asarray(system.eet, np.float32), want.eet),
        ("p_dyn", np.asarray(system.p_dyn, np.float32), want.p_dyn),
        ("p_idle", np.asarray(system.p_idle, np.float32), want.p_idle),
        ("site_of_machine", got_sites, want.sites),
    ) if a.shape != b.shape or not np.array_equal(a, b)]
    if int(system.queue_size) != want.queue_size:
        problems.append("queue_size")
    if np.float32(system.fairness_factor) != np.float32(
            want.fairness_factor):
        problems.append("fairness_factor")
    if problems:
        raise RuntimeError(f"the port's system {cfg['fleet']!r} differs from "
                           f"the configuration file in {problems}")


def sweep_spec(mix: dict, cfg: dict):
    """The program's ``SweepSpec`` of a cell: its system, heuristic,
    dispatcher and kernel route (the traces come from the benchmark)."""
    from repro_torch.experiments.spec import SweepSpec

    return SweepSpec(system=cfg["fleet"], rates=tuple(mix["rates"]),
                     reps=int(mix["reps"]), n_tasks=int(mix["n_tasks"]),
                     heuristics=(mix["heuristic"],), cv_run=mix["cv_run"],
                     dispatcher=mix["dispatcher"],
                     use_fused_map=mix["use_fused_map"],
                     use_fused_phase1=mix["use_fused_phase1"])


def host_rows(traces, rows, B: int, dev) -> list:
    """Rows ``rows`` of a (R, K, ...) trace stack, flattened to B rows,
    copied to the host as the reference takes them."""
    import torch

    idx = torch.as_tensor(rows, device=dev)
    host = [x.reshape((B,) + tuple(x.shape[2:]))[idx].cpu().numpy()
            for x in traces]
    return [dict(zip(("arrival", "task_type", "deadline", "exec_actual"),
                     (h[i] for h in host))) for i in range(len(rows))]


def device_records(prof, torch) -> list:
    """``(name, start_us, end_us)`` of every device operation recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == cuda)


def timeline(records: list) -> tuple:
    """``(busy seconds, kernels {name: [count, seconds]}, device ops
    {name: seconds}, idle gaps {label: seconds})`` of device records."""
    records = sorted(records, key=lambda r: r[1])
    busy, gaps, ops, kernels = 0.0, {}, {}, {}
    end, last = None, None
    for name, a, b in records:
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
        if not name.startswith(("Memcpy", "Memset")):
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) * 1e-6
        if end is None or a > end:
            if end is not None:
                label = f"after {last[:72]}"
                gaps[label] = gaps.get(label, 0.0) + (a - end) * 1e-6
            busy += (b - a) * 1e-6
            end, last = b, name
        elif b > end:
            busy += (b - end) * 1e-6
            end, last = b, name
    return busy, kernels, ops, gaps


def top(d: dict, n: int = 10) -> list:
    return [[k[:96], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:n] if v > 0]


def launch_counts() -> dict:
    """The program's own launch counters of :data:`KERNELS`."""
    from repro_torch.kernels.map_fused import ops as map_ops
    from repro_torch.kernels.phase1_map import ops as p1_ops

    both = dict(map_ops.LAUNCHES, **p1_ops.LAUNCHES)
    return {k: both[k] for k in KERNELS}


class _Ticking(dict):
    """``engine.COUNTS`` while the traced simulation runs: every loop
    iteration calls ``tick`` with the program's new iteration count."""

    def __init__(self, counts: dict, tick):
        super().__init__(counts)
        self.tick = tick

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "loop_iterations":
            self.tick(value)


def traced_window(simulate, engine, torch, on_card: bool, sync,
                  n: int) -> dict | None:
    """Profile loop iterations ``TRACE_SKIP`` to ``TRACE_SKIP + n`` of
    ``simulate()``, one simulation of at least that many iterations.
    Returns the window's device records, its host seconds between the
    two synchronisations and the program's launches in it; ``None``
    where the simulation ended first."""
    from torch.profiler import ProfilerActivity, profile, schedule

    counts, it0, marks = engine.COUNTS, engine.COUNTS["loop_iterations"], {}

    def mark(done):
        sync()
        marks[done] = (time.perf_counter(), launch_counts())

    def tick(value):
        done = value - it0
        if done == TRACE_SKIP + n:      # the window closes, then the
            mark(done)                  # profiler stops
        if done == TRACE_SKIP:          # the card idles as it starts
            sync()
        prof.step()
        if done == TRACE_SKIP:
            mark(done)

    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU],
                 schedule=schedule(wait=TRACE_SKIP - 2, warmup=2, active=n,
                                   repeat=1)) as prof:
        engine.COUNTS = _Ticking(counts, tick)
        try:
            simulate()
        finally:
            counts["loop_iterations"] = engine.COUNTS["loop_iterations"]
            engine.COUNTS = counts
    if len(marks) < 2:
        return None
    (t_a, l_a), (t_b, l_b) = marks[TRACE_SKIP], marks[TRACE_SKIP + n]
    return dict(records=device_records(prof, torch), wall_s=t_b - t_a,
                launches={k: l_b[k] - l_a[k] for k in KERNELS})


def dropped_records(kernels: dict, launches: dict) -> dict:
    """Kernels whose recorded launches differ from the program's count
    of them, where the program counted some: ``{name: (recorded,
    counted)}``."""
    out = {}
    for k, counted in launches.items():
        recorded = sum(c for name, (c, _) in kernels.items()
                       if f"{k}_kernel" in name)
        if counted and recorded != counted:
            out[k] = (recorded, counted)
    return out


def run(argv, *, t0=None, device=None, mix_overrides=None) -> int:
    """Run one cell once; print its result line; return the exit code.
    ``t0``: the process's start on ``time.perf_counter``'s clock.
    ``device`` (tests only) skips the look for a card and runs there;
    ``mix_overrides`` (tests only) resizes the mix."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = cells.Cell(args.workload)
    mix = dict(cell.mix, **(mix_overrides or {}))
    cfg = cell.config
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"error: {cell.name} needs {cell.chips} CUDA device(s); "
                f"found {torch.cuda.device_count()}")
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    torch.set_num_threads(1)
    if on_card := dev.type == "cuda":
        torch.cuda.init()
    log(f"at {time.perf_counter() - t0:.3f} s: torch and the device")
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.core import engine
        from repro_torch.experiments import runner
    except ImportError as e:
        log(f"error: the program under test is not here ({e})")
        return 2
    if on_card:
        from repro_torch.kernels import build

        srcs = (("map_fused", "balance_scan") if mix["use_fused_map"]
                else ()) + (("phase1_map",) if mix["use_fused_phase1"]
                            else ())
        built = build.build(srcs)
        log("kernels", {k: round(v["seconds"], 2) for k, v in built.items()})
    log(f"at {time.perf_counter() - t0:.3f} s: the program and its kernels")

    spec = sweep_spec(mix, cfg)
    check_system(cfg, spec.resolve_system())
    system = sim.System(cfg)
    R, K, N = len(mix["rates"]), int(mix["reps"]), int(mix["n_tasks"])
    B = R * K

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # ---- set-up: the warm-up at the cell's own shapes, cut short
    warm = traffic.stack(mix, system.eet, args.seed, WARM_BATCH, dev)
    sync()
    log(f"at {time.perf_counter() - t0:.3f} s: the warm-up's traces")
    runner.run_sweep(dataclasses.replace(
        spec, max_steps=int(mix["warmup_steps"])), traces=warm, device=dev)
    del warm
    sync()
    setup_s = time.perf_counter() - t0
    log(f"setup_s {setup_s:.3f}")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # ---- the measured window: whole batches
    per_rate = int(mix["check_per_rate"])
    kept, iters = [], []
    violations, batch_peak = 0, 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_first = time.perf_counter()
    b = 0
    while True:
        tr = traffic.stack(mix, system.eet, args.seed, b, dev)
        it0 = engine.COUNTS["loop_iterations"]
        res = runner.run_sweep(spec, traces=tr, device=dev)
        t_end = time.perf_counter()
        iters.append(engine.COUNTS["loop_iterations"] - it0)
        if b == 0 and on_card:
            batch_peak = torch.cuda.max_memory_allocated(dev)
        m = {k: np.asarray(v)[0].reshape((B,) + np.shape(v)[3:])
             for k, v in res.metrics._asdict().items()}
        violations += compare.invariant_violations(m, N)
        rows = compare.candidates(args.seed, b, R, K, per_rate)
        kept.append([(trace, {k: v[row] for k, v in m.items()})
                     for row, trace in zip(rows, host_rows(tr, rows, B,
                                                           dev))])
        del tr, res
        log(f"batch {b} {t_end - t_first:.3f} s iterations {iters[-1]}")
        b += 1
        if t_end - t_first >= args.seconds:
            break
    window_s = t_end - t_first
    n_batches = b
    rate = n_batches * B * N / window_s
    log(f"sim_tasks_per_s {rate:.1f}")
    metrics, extra = {}, {}
    if on_card:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))

    if args.trace:
        # ---- the traced window: batch 0 simulated once more, profiled
        # over trace_steps iterations after the first TRACE_SKIP
        tr = traffic.stack(mix, system.eet, args.seed, 0, dev)
        n = int(mix["trace_steps"])
        cut = dataclasses.replace(spec, max_steps=TRACE_SKIP + n)
        traced = traced_window(
            lambda: runner.run_sweep(cut, traces=tr, device=dev),
            engine, torch, on_card, sync, n)
        del tr
        if on_card:
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
        obs = types.SimpleNamespace(
            cell=cell, geometry=cell.geometry, window_s=window_s,
            window_iters=sum(iters), batch_iters=iters[0],
            batch_peak_bytes=batch_peak, trace_wall_s=0.0, trace_iters=0,
            busy_s=0.0, kernels={})
        breakdown = {"device_ops": [], "idle_gaps": []}
        if traced is not None:
            busy, kernels, ops, gaps = timeline(traced["records"])
            log(f"traced {n} iterations, {traced['wall_s']:.3f} s, "
                f"launches {traced['launches']}")
            dropped = dropped_records(kernels, traced["launches"])
            if dropped:
                log(f"error: the profiler's records of {sorted(dropped)} "
                    f"differ from the program's launches (recorded, "
                    f"counted): {dropped}")
                return 4
            obs.trace_wall_s, obs.trace_iters = traced["wall_s"], n
            obs.busy_s, obs.kernels = busy, kernels
            extra = {"busy_s": busy, "window_s": traced["wall_s"]}
            breakdown = {"device_ops": top(ops), "idle_gaps": top(gaps)}
        for mdef in cell.per_layer:
            value = cells.reader(mdef["name"])(obs)
            if value is not None:
                metrics[mdef["name"]] = {"value": value,
                                         "unit": mdef["unit"]}
    else:
        values = {"sim_tasks_per_s": rate, "setup_s": setup_s}
        for mdef in cell.end_to_end:
            metrics[mdef["name"]] = {"value": values[mdef["name"]],
                                     "unit": mdef["unit"]}
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        log(f"error: forbidden modules loaded in the reporting process: "
            f"{found}")
        return 3

    # ---- the check, once the window has closed and its state is freed
    t_check = time.perf_counter()
    batch_of = compare.pick(args.seed, n_batches, len(kept[0]))
    results = compare.check_sample(
        [kept[bb][slot] for slot, bb in enumerate(batch_of)], system,
        mix["heuristic"], mix["dispatcher"])
    values = dict(invariant_violations=violations,
                  **compare.summarize(results))
    correct, checks = compare.verdict(values, compare.LIMITS)
    failed = violations + sum(d or g > compare.LIMITS["energy_gap"]
                              for d, g in results)
    line = {"correct": correct, "attempted": n_batches * B,
            "failed": int(failed), "metrics": metrics,
            "device": {"platform": "gpu" if on_card else dev.type,
                       "kind": (torch.cuda.get_device_name(dev) if on_card
                                else dev.type),
                       "count": 1, "memory_peak_bytes": int(peak), **extra}}
    if args.trace:
        line["breakdown"] = breakdown
    line["checks"] = checks
    log(f"batches {n_batches} window_s {window_s:.3f} sampled {len(results)}"
        f" check_s {time.perf_counter() - t_check:.3f}")
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
