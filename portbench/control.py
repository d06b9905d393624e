"""The control's readings, which set the upper end of the limits of
``portbench/compare.py``.

    python3 portbench/control.py --workload NAME --seeds 1,2,3

For each seed the cell's batch 0 (the window's first batch) is drawn on
the card at the cell's own size, as a run draws it, and the check sample
that a run of one batch takes from it is run through the plain
reference twice: computed in bfloat16, the precision below the
configuration's float32, in the program's place, and in float32 as the
reference it is held to. The program itself does not run: a run's own
``checks`` give the sound readings. Each reading is one JSON line on
standard output. The benchmark's own runs do not run this.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import cells, compare, harness, traffic  # noqa: E402
from portbench.reference import sim  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = cells.Cell(args.workload)
    mix, system = cell.mix, sim.System(cell.config)
    policy, dispatcher = mix["heuristic"], mix["dispatcher"]
    R, K = len(mix["rates"]), int(mix["reps"])
    import torch

    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        rows = compare.candidates(seed, 0, R, K, int(mix["check_per_rate"]))
        traces = harness.host_rows(traffic.stack(mix, system.eet, seed, 0,
                                                 dev), rows, R * K, dev)
        values = compare.summarize([compare.gaps(
            sim.simulate(t, system, policy, dispatcher, precision="bfloat16"),
            sim.simulate(t, system, policy, dispatcher)) for t in traces])
        ok, _ = compare.verdict(values, compare.LIMITS)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "kind": "control", "correct": ok,
                          "sampled": len(traces),
                          "seconds": time.perf_counter() - t0, **values}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
