#!/usr/bin/env python3
"""Loop iterations and on-time shares of ``chip_smoke.py``'s scenarios
phase, from the port on the CPU.

    PYTHONPATH=src python scripts/torch_scenario_iterations.py
    PYTHONPATH=src python scripts/torch_scenario_iterations.py \\
        --reps 30 --tasks 2000 --only workloads

Runs the phase's sweeps (``chip_smoke.WORKLOAD_SCENARIOS``, each on its
own, and ``chip_smoke.SCENARIO_RUNS``) on the same traces as the card,
through the kernels' plain versions. The port gives the same bits on
both devices, so the batched loop iterations printed are the ones the
card must count (the phase's batch of the seven workload scenarios runs
as many as the longest of them), and the on-time shares are the card's.
A prediction of the card's counts, not a device measurement.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the phase's runs and their constants)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--tasks", type=int, default=2000)
    ap.add_argument("--only", choices=("workloads", "fleets"),
                    help="run one half of the phase")
    args = ap.parse_args(argv)

    from repro_torch.experiments import SweepSpec, run_sweep

    runs = []
    if args.only != "fleets":
        runs += [(f"paper {h} {name}", name, None, chip_smoke.RATES, h,
                  None, "paper")
                 for name in chip_smoke.WORKLOAD_SCENARIOS
                 for h in ("FELARE", "ELARE")]
    if args.only != "workloads":
        runs += list(chip_smoke.SCENARIO_RUNS)
    for run in runs:
        spec = chip_smoke.scenario_spec(run, args.reps, args.tasks)
        res = run_sweep(spec, device="cpu")
        info = res.run_info[run[4]]
        print(json.dumps({
            "run": run[0], "reps": args.reps, "tasks": args.tasks,
            "loop_iterations": info["loop_iterations"],
            "cpu_seconds": round(info["seconds"], 1),
            "completion_rate": [round(float(v), 6)
                                for v in res.completion_rate[0]]}),
            flush=True)


if __name__ == "__main__":
    main()
