"""Every entry of BENCHMARK.json finds its files by name, and the file
keeps to the benchmark's contract: names, units, bounds, cells."""
import json
import math
import re

import numpy as np
import pytest

from portbench_common import ROOT
from portbench import cells, harness
from repro_torch.experiments.spec import SweepSpec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            seen.add((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(set(WORKLOADS)) == len(WORKLOADS)


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_loads(name):
    cell = cells.Cell(name, BENCH)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "sim_tasks_per_s"}
    assert cell.per_layer
    mix, cfg = cell.mix, cell.config
    for key in ("heuristic", "dispatcher", "use_fused_map",
                "use_fused_phase1", "rates", "reps", "n_tasks", "scenario",
                "cv_run", "dyadic", "warmup_steps", "trace_steps",
                "check_per_rate"):
        assert key in mix, key
    spec = SweepSpec(system=cfg["fleet"], rates=tuple(mix["rates"]),
                     reps=mix["reps"], n_tasks=mix["n_tasks"],
                     heuristics=(mix["heuristic"],),
                     dispatcher=mix["dispatcher"])
    harness.check_system(cfg, spec.resolve_system())
    geo = cell.geometry
    assert geo["B"] * geo["N"] >= 10_000_000


def test_a_changed_deployment_is_refused():
    cell = cells.Cell(WORKLOADS[0], BENCH)
    cfg = json.loads(json.dumps(cell.config))
    cfg["eet"][0][0] += 0.001
    with pytest.raises(RuntimeError, match="eet"):
        harness.check_system(cfg, SweepSpec(
            system=cfg["fleet"]).resolve_system())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m["workloads"]) <= set(WORKLOADS)
    read = cells.reader(metric)
    assert callable(read)


def test_configs_are_files_of_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_readers_on_a_trace_summary():
    """The readers' arithmetic on a made-up traced window."""
    import types

    geo = dict(B=20480, N=800, M=32, S=4, F=8)
    obs = types.SimpleNamespace(
        geometry=geo, trace_wall_s=2.0, trace_iters=100, busy_s=1.5,
        window_s=40.0, window_iters=2000, batch_iters=1632, batch_peak_bytes=3 * 2**30,
        kernels={"void map_decide_kernel<4>(...)": [100, 0.1],
                 "balance_scan_kernel(...)": [100, 0.02],
                 "elementwise": [30000, 1.0]})
    got = {m: cells.reader(m)(obs) for m in (
        "ms_per_iter", "launches_per_iter", "iters_per_batch",
        "device_idle_share", "peak_mem_gib", "map_decide_roofline",
        "balance_scan_roofline", "evict_stats_roofline")}
    assert got["ms_per_iter"] == 20.0
    assert got["launches_per_iter"] == 302.0
    assert got["iters_per_batch"] == 1632
    assert math.isclose(got["device_idle_share"], 25.0)
    assert got["peak_mem_gib"] == 3.0
    assert got["evict_stats_roofline"] is None      # nothing recorded
    assert 0 < got["map_decide_roofline"] < 100
    assert 0 < got["balance_scan_roofline"] < 100


def test_dropped_records():
    kernels = {"void map_decide_kernel<4>(...)": [512, 0.1],
               "evict_stats_kernel(...)": [255, 0.05],
               "elementwise": [9000, 1.0]}
    launches = {"map_decide": 512, "evict_stats": 256, "balance_scan": 0,
                "phase1_map": 0}
    assert harness.dropped_records(kernels, launches) == {
        "evict_stats": (255, 256)}
    launches["evict_stats"] = 255
    assert harness.dropped_records(kernels, launches) == {}


def test_traced_window_leaves_the_set_up_out(capsys):
    """On the CPU at a tiny size: the traced window follows the measured
    window, opens after TRACE_SKIP iterations and holds trace_steps of
    them; ms_per_iter is the measured window's."""
    small = dict(reps=4, n_tasks=120, warmup_steps=5, trace_steps=32,
                 check_per_rate=2)
    rc = harness.run(["--workload", WORKLOADS[0], "--seed", "2147483677",
                      "--seconds", "0", "--trace", "1"], device="cpu",
                     mix_overrides=small)
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert "traced 32 iterations" in err
    assert err.index("batch 0 ") < err.index("traced 32 iterations")
    assert {"ms_per_iter", "iters_per_batch"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("name", WORKLOADS)
def test_sample_spreads_over_the_rows(name):
    """At each rate the sample has a replicate in every block of the
    rate's replicates, the last included; in a federation some of its
    site rows lie past 65,535."""
    from portbench import compare

    cell = cells.Cell(name, BENCH)
    geo, per = cell.geometry, cell.mix["check_per_rate"]
    K, R = cell.mix["reps"], len(cell.mix["rates"])
    for seed in (1, 2147483659, 2**31 + 12345):
        rows = compare.candidates(seed, 3, R, K, per)
        assert len(rows) == R * per
        block = (rows % K) * per // K
        assert (rows // K == np.repeat(np.arange(R), per)).all()
        assert (block == np.tile(np.arange(per), R)).all()
        if geo["F"] > 1:
            assert (rows * geo["F"] + geo["F"] - 1).max() > 65_535
        batch_of = compare.pick(seed, 3, len(rows))
        assert batch_of.min() >= 0 and batch_of.max() < 3
