"""Shared pieces of the benchmark's CPU tests: the port on the CPU, the
benchmark's traces at a tiny size, the configuration files."""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

from portbench import traffic  # noqa: E402
from portbench.reference import sim  # noqa: E402

CONFIGS = {name: json.loads((ROOT / "portbench" / "configs" /
                             f"{name}.json").read_text())
           for name in ("paper-hec-4x4", "paper-x8")}


def tiny_stack(cfg, rates, reps, n_tasks, seed=3000000017, batch=0):
    """The benchmark's traces of one batch, on the CPU."""
    mix = dict(scenario="poisson", rates=list(rates), reps=reps,
               n_tasks=n_tasks, cv_run=0.1, dyadic=64)
    return traffic.stack(mix, np.asarray(cfg["eet"], np.float32), seed,
                         batch, "cpu")


def row(traces, r, k) -> dict:
    """One trace of a stack as the reference takes it."""
    return dict(zip(("arrival", "task_type", "deadline", "exec_actual"),
                    (x[r, k].numpy() for x in traces)))


def system(cfg) -> "sim.System":
    return sim.System(cfg)
