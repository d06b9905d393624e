#!/usr/bin/env python3
"""A benchmark cell's loop seen through the span recorder and the loop's
always-on counters, on the card.

    python scripts/torch_span_window.py --workload paper4x4.felare_fused \
        [--seed N] [--batches 2] [--pairs 3] [--out spans.json]

For one cell of ``BENCHMARK.json`` at its own size, in one process: the
warm-up, then ``--batches`` untraced batches (their wall ms per
iteration, and the host's issue ms per iteration from
``engine.COUNTS``, with and without the warm-up's counts); then the
recorder's cost, the cell's traced window (iterations 64-320 of batch 0,
synchronised at both ends) timed ``--pairs`` times with the recorder off
and on in turns, with the last such window's stages; last, as the
benchmark's ``--trace 1`` run does, that window once more under
``torch.profiler`` (device records only) with the recorder on: the
per-stage host and card ms per iteration, the card's idle gaps put down
to the innermost host span open during them, and the host's share of
time waiting in the periodic check. Prints one JSON
object and writes it to ``--out``. ``--device cpu`` runs the same at the
mix's size on the CPU (rehearsal only: no card number).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import cells, harness, traffic  # noqa: E402
from portbench.reference import sim  # noqa: E402
from repro_torch.core import engine, spans  # noqa: E402
from repro_torch.experiments import runner  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2147483693)
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--small", action="store_true",
                   help="a tiny mix (rehearsal on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    cell = cells.Cell(args.workload)
    mix = dict(cell.mix)
    if args.small:
        mix.update(reps=4, n_tasks=120, warmup_steps=5, trace_steps=32)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    torch.set_num_threads(1)
    if on_card:
        from repro_torch.kernels import build

        build.build((("map_fused", "balance_scan") if mix["use_fused_map"]
                     else ()) + (("phase1_map",) if mix["use_fused_phase1"]
                                 else ()))

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    spec = harness.sweep_spec(mix, cell.config)
    eet = sim.System(cell.config).eet
    out = dict(workload=cell.name, seed=args.seed, device=(
        torch.cuda.get_device_name(dev) if on_card else "cpu"))

    # ---- the warm-up, as the harness's
    warm = traffic.stack(mix, eet, args.seed, harness.WARM_BATCH, dev)
    c0 = dict(engine.COUNTS)
    runner.run_sweep(dataclasses.replace(
        spec, max_steps=int(mix["warmup_steps"])), traces=warm, device=dev)
    del warm
    sync()
    c1 = dict(engine.COUNTS)

    # ---- untraced batches
    t0 = time.perf_counter()
    for b in range(args.batches):
        tr = traffic.stack(mix, eet, args.seed, b, dev)
        runner.run_sweep(spec, traces=tr, device=dev)
        del tr
    window_s = time.perf_counter() - t0
    c2 = dict(engine.COUNTS)

    def per_iter(a, b):
        return (b["issue_ns"] - a["issue_ns"]) * 1e-6 / (
            b["issue_iters"] - a["issue_iters"])

    iters = c2["loop_iterations"] - c1["loop_iterations"]
    out["untraced"] = dict(
        batches=args.batches, iterations=iters,
        ms_per_iter=window_s * 1e3 / iters,
        host_issue_ms_per_iter=per_iter(c1, c2),
        host_issue_ms_per_iter_with_warmup=per_iter(c0, c2),
        warmup_issue_ms=(c1["issue_ns"] - c0["issue_ns"]) * 1e-6,
        warmup_issue_iters=c1["issue_iters"] - c0["issue_iters"],
        checks=c2["checks"] - c1["checks"],
        host_wait=(c2["check_wait_ns"] - c1["check_wait_ns"]) * 1e-9
        / window_s)

    # ---- the traced window, recorder off and on in turns
    n, skip = int(mix["trace_steps"]), harness.TRACE_SKIP
    cut = dataclasses.replace(spec, max_steps=skip + n)
    tr = traffic.stack(mix, eet, args.seed, 0, dev)

    def window(record: bool, prof=None):
        counts, it0, marks = engine.COUNTS, engine.COUNTS[
            "loop_iterations"], {}

        def tick(value):
            done = value - it0
            if done in (skip, skip + n):
                sync()
                marks[done] = time.perf_counter_ns()
            if prof is not None:
                prof.step()

        engine.COUNTS = harness._Ticking(counts, tick)
        try:
            with (spans.recording() if record
                  else contextlib.nullcontext()) as rec:
                runner.run_sweep(cut, traces=tr, device=dev)
        finally:
            counts["loop_iterations"] = engine.COUNTS["loop_iterations"]
            engine.COUNTS = counts
        return marks[skip], marks[skip + n], rec, it0

    cost = {"off": [], "on": []}
    for _ in range(args.pairs):
        for mode in ("off", "on"):
            a, b, rec, it0 = window(mode == "on")
            cost[mode].append((b - a) * 1e-6 / n)
    out["recorder_cost"] = dict(
        cost, median_off=float(np.median(cost["off"])),
        median_on=float(np.median(cost["on"])))
    if args.pairs:
        # the last window with the recorder on, not profiled
        out["unprofiled"] = dict(
            stages=spans.stage_table(rec.spans,
                                     range(it0 + skip, it0 + skip + n)),
            host_wait=spans.host_wait_share(rec.spans, a, b))

    # ---- the profiled window with the recorder on (last: the profiler
    # slows what follows it in the process)
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU],
                 schedule=schedule(wait=skip - 2, warmup=2, active=n,
                                   repeat=1)) as prof:
        a, b, rec, it0 = window(True, prof)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    records = harness.device_records(prof, torch)
    busy, kernels, _, _ = harness.timeline(records)
    wall = (b - a) * 1e-9
    its = range(it0 + skip, it0 + skip + n)
    table = spans.stage_table(rec.spans, its)
    dev_sum = sum(r["device_ms"] or 0.0 for r in table.values())
    ua, ub = (spans.to_unix_ns(rec.clock, t) for t in (a, b))
    intervals = [(ua, ua), (ub, ub)] + [
        (start_ns + int(s * 1e3), start_ns + int(e * 1e3))
        for _, s, e in records]
    idle = spans.idle_by_span(rec.spans, rec.clock, intervals)
    records_in = [(s, e) for s, e in intervals[2:] if ua <= s and e <= ub]
    out["traced"] = dict(
        iterations=n, wall_s=wall, ms_per_iter=wall * 1e3 / n,
        launches_per_iter=sum(c for c, _ in kernels.values()) / n,
        busy_s=busy, idle_s=wall - busy,
        records_inside_window=len(records_in), records=len(records),
        stages=table, stage_device_ms_sum=dev_sum,
        top_device_stage=max(table, key=lambda k: table[k]["device_ms"]
                             or 0.0),
        idle_by_span=harness.top(idle),
        idle_by_span_sum=sum(idle.values()),
        host_wait=spans.host_wait_share(rec.spans, a, b))
    print(spans.format_stage_table(table), file=sys.stderr)
    text = json.dumps(out, indent=1, default=float)
    print(text)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    return out


if __name__ == "__main__":
    main()
