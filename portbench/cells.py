"""Where the benchmark's data lives, found by the names in BENCHMARK.json.

A cell names a configuration (``configs[].file``, the deployment's
tables) and a traffic mix (``portbench/mixes/<traffic>.json``: the
heuristic, the dispatcher, the kernel route and the trace parameters).
A per-layer metric is read by ``portbench/metrics/<name>.py``. Adding a
cell or a metric adds files and entries; no code here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "BENCHMARK.json"
MIXES = ROOT / "portbench" / "mixes"


def load_bench() -> dict:
    return json.loads(BENCH.read_text())


class Cell:
    """One workload entry with its configuration and mix loaded."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = load_bench() if bench is None else bench
        try:
            self.entry = next(w for w in bench["workloads"]
                              if w["name"] == name)
        except StopIteration:
            known = [w["name"] for w in bench["workloads"]]
            raise KeyError(f"unknown workload {name!r}; known: {known}") \
                from None
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.entry["config"])
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.mix = json.loads(
            (MIXES / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def geometry(self) -> dict:
        """B replicates, N tasks, M machines, S types, F sites."""
        S, M = len(self.config["eet"]), len(self.config["eet"][0])
        sites = self.config.get("site_of_machine")
        return dict(B=len(self.mix["rates"]) * int(self.mix["reps"]),
                    N=int(self.mix["n_tasks"]), M=M, S=S,
                    F=1 if sites is None else max(sites) + 1)


def reader(metric: str):
    """The ``read(obs)`` function of a per-layer metric, from
    ``portbench/metrics/<metric>.py`` (a name may hold dots)."""
    path = ROOT / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
