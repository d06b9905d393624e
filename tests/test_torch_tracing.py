"""The span recorder (``repro_torch.core.spans``) and the loop's
always-on counters (``engine.COUNTS``), on the CPU.

Recording changes no result and no op, records nothing while off, and
its spans agree with the counters and with the loop's own structure:
one ``engine.iter`` per counted iteration, ``engine.check`` only on
check iterations, the stages in ``engine.STAGES`` order without
overlap. The readers' arithmetic (the stage table, the host's wait,
idle gaps put down to host spans) on made-up spans.
"""
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import find_repo_root, walk_audit
from repro_torch.analysis.programs import simulator_program
from repro_torch.core import engine, spans
from repro_torch.experiments import runner, sweep
from repro_torch.experiments.spec import SweepSpec

torch.set_num_threads(1)

COUNTERS = ("loop_iterations", "checks", "check_wait_ns", "issue_ns",
            "issue_iters")

#: Sweeps that between them run every stage: flat; federated with a
#: dispatcher; with a machine dynamics (the faults stage); with
#: observers; on the kernels' route (plain versions on the CPU).
SPECS = {
    "flat": dict(system="paper", heuristics=("ELARE", "FELARE")),
    "federated": dict(system="paper_x2", dispatcher="fair_spill",
                      heuristics=("FELARE",)),
    "faults": dict(system="paper_x2", dispatcher="fair_spill",
                   dynamics="site_outage", heuristics=("FELARE",)),
    "observed": dict(system="paper", heuristics=("FELARE",),
                     observers=("timeline", "task_log")),
    "fused": dict(system="paper_x2", dispatcher="fair_spill",
                  heuristics=("FELARE",), use_fused_map=True),
}


def spec_of(name, **kw):
    return SweepSpec(rates=(2.0, 6.0), reps=2, n_tasks=40, seed=5,
                     **dict(SPECS[name], **kw))


def counts():
    return {k: engine.COUNTS[k] for k in COUNTERS}


def delta(before):
    return {k: engine.COUNTS[k] - before[k] for k in COUNTERS}


def recorded(name, **kw):
    """A recorded CPU sweep: ``(result, recorder, counter deltas)``."""
    before = counts()
    with spans.recording() as rec:
        res = runner.run_sweep(spec_of(name, **kw), device="cpu")
    return res, rec, delta(before)


def leaves(res):
    out = dict(res.metrics._asdict())
    for ob, d in (res.aux or {}).items():
        for k, v in d.items():
            out[f"{ob}.{k}"] = v
    return out


def iterations(rec):
    return [s for s in rec.spans if s.name == "engine.iter"]


# ------------------------------------------------------------ the results
@pytest.mark.parametrize("name", list(SPECS))
def test_results_bit_identical_with_the_recorder_on_and_off(name):
    off = runner.run_sweep(spec_of(name), device="cpu")
    on, rec, _ = recorded(name)
    assert rec.spans
    a, b = leaves(off), leaves(on)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_while_off_nothing_is_recorded(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span or event was made while off")

    monkeypatch.setattr(spans.Span, "__init__", refuse)
    monkeypatch.setattr(spans.Recorder, "_event", refuse)
    monkeypatch.setattr(spans.Recorder, "open", refuse)
    before = counts()
    runner.run_sweep(spec_of("faults"), device="cpu")
    assert spans.current() is None
    assert delta(before)["loop_iterations"] > 0


def test_recording_hands_over_closed_spans_and_does_not_nest():
    with spans.recording() as rec:
        with pytest.raises(RuntimeError, match="already"):
            with spans.recording():
                pass
        assert spans.current() is rec
        runner.run_sweep(spec_of("flat"), device="cpu")
    assert spans.current() is None
    assert all(s is not None and s.end >= s.start for s in rec.spans)
    assert [s.id for s in rec.spans] == sorted(s.id for s in rec.spans)
    perf, unix = rec.clock
    assert spans.to_unix_ns(rec.clock, perf + 5) == unix + 5


# --------------------------------------------------------- the span tree
def test_the_tree_of_one_sweep():
    _, rec, _ = recorded("flat")
    by_id = {s.id: s for s in rec.spans}
    kids = spans.children(rec.spans)
    (root,) = kids[None]
    assert root.name == "sweep" and root.sweep == root.id
    assert [s.name for s in kids[root.id]] == [
        "sweep.simulate", "sweep.simulate", "sweep.wrap"]
    assert [s.attrs["heuristic"] for s in kids[root.id][:2]] == [
        "ELARE", "FELARE"]
    for sim in kids[root.id][:2]:
        names = [s.name for s in kids[sim.id]]
        # the loop's last pass (its check ends the loop) is no iteration
        n = names.count("engine.iter")
        assert names == (["engine.setup"] + ["engine.iter"] * n
                         + ["engine.next_event", "engine.check",
                            "engine.finish", "sweep.to_host"])
    for s in rec.spans:
        assert s.sweep == root.id
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end
        # nothing on the CPU records the card's time, nor drains it
        assert "device_ms" not in s.attrs and s.name != "sweep.drain"


def test_iter_spans_equal_the_counted_iterations():
    for name in ("flat", "faults"):
        _, rec, d = recorded(name)
        its = iterations(rec)
        assert len(its) == d["loop_iterations"] > 0
        # ``it`` is engine.COUNTS as the iteration starts
        got = [s.attrs["it"] for s in its]
        assert got == sorted(set(got))


def test_check_only_on_check_iterations():
    _, rec, d = recorded("faults")
    kids = spans.children(rec.spans)
    sims = [s for s in rec.spans if s.name == "sweep.simulate"]
    for sim in sims:
        its = [s for s in kids[sim.id] if s.name == "engine.iter"]
        it0 = its[0].attrs["it"]
        for s in its:
            has = [c.name for c in kids[s.id]].count("engine.check")
            assert has == ((s.attrs["it"] - it0) % engine.CHECK_EVERY == 0)
    assert sum(s.name == "engine.check" for s in rec.spans) == d["checks"]


@pytest.mark.parametrize("name", ["flat", "faults"])
def test_stages_follow_STAGES_in_order_without_overlap(name):
    _, rec, _ = recorded(name)
    kids = spans.children(rec.spans)
    stages = [s for s in engine.STAGES
              if name == "faults" or s != "faults"]
    for it in iterations(rec):
        got = [c.name.partition(".")[2] for c in kids[it.id]]
        check = ["check"] if "check" in got else []
        assert got == ["next_event"] + check + stages + ["freeze"]
        cs = kids[it.id]
        assert cs[0].start == it.start and cs[-1].end == it.end
        for a, b in zip(cs, cs[1:]):
            assert a.end == b.start       # abutting: no gap, no overlap
        assert all(c.id not in kids for c in cs)


def test_counters_agree_with_the_spans():
    _, rec, d = recorded("federated")
    kids = spans.children(rec.spans)
    checks = [s for s in rec.spans if s.name == "engine.check"]
    assert d["checks"] == len(checks)
    assert d["check_wait_ns"] == sum(s.end - s.start for s in checks)
    # a loop's first iteration is left out, and the check that ends it
    its = iterations(rec)
    timed = [(it, c) for it in its[1:] for c in kids[it.id]
             if c.name == "engine.check"]
    assert d["issue_iters"] == len(timed) == len(checks) - 2  # 1 loop
    assert d["issue_ns"] == sum(it.end - c.end for it, c in timed)
    # the stage table's host ms after the check are that issue time
    table = spans.stage_table(rec.spans)
    after = [r["host_ms"] for k, r in table.items()
             if k not in ("next_event", "check")]
    assert math.isclose(sum(after), d["issue_ns"] * 1e-6 / len(timed))


def test_counters_count_while_off():
    before = counts()
    runner.run_sweep(spec_of("flat"), device="cpu")
    d = delta(before)
    runs = 2                                   # two heuristics
    # each loop checks at 0, 32, ... and once more where it ends
    assert d["checks"] == d["loop_iterations"] // engine.CHECK_EVERY + runs
    assert d["issue_iters"] == d["checks"] - 2 * runs
    assert d["check_wait_ns"] > 0 and d["issue_ns"] > 0


def test_a_swapped_counts_dict_gets_the_updates(monkeypatch):
    mine = dict.fromkeys(COUNTERS, 0)
    monkeypatch.setattr(engine, "COUNTS", mine)
    runner.run_sweep(spec_of("flat", heuristics=("FELARE",)), device="cpu")
    assert mine["loop_iterations"] > 0 and mine["checks"] > 0


# ------------------------------------------------------------- the walk
def test_a_walk_has_the_same_ops_with_the_recorder_on_and_off():
    def program(on):
        def build():
            fn, args = simulator_program(fleet="paper_x2",
                                         heuristic="FELARE", device="cpu",
                                         dynamics="bernoulli_updown",
                                         observers=("timeline",))
            if not on:
                return fn, args

            def recorded_fn(*a):
                with spans.recording():
                    return fn(*a)
            return recorded_fn, args
        return build

    # the process's first walk of a fleet also fills the set-up's caches
    first = walk_audit.walk_program(program(False), device="cpu")
    on = walk_audit.walk_program(program(True), device="cpu")
    off = walk_audit.walk_program(program(False), device="cpu")
    assert first.iterations == off.iterations == on.iterations >= 3
    assert off.full() and first.full() == off.full() == on.full()
    assert off.buckets == on.buckets


def test_the_layer_1_checker_stays_clean():
    root = find_repo_root()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check", "--layer", "1"],
        cwd=root, capture_output=True, text=True,
        env={"PYTHONPATH": f"{root}/src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout


# ---------------------------------------------------------- the readers
def _span(name, start, end, sid, parent=None, **attrs):
    s = spans.Span(name, start, sid, parent, 0, attrs)
    s.end = end
    return s


def test_stage_table_arithmetic():
    # a loop's first iteration (its check is left out of host_ms), a
    # check iteration, a plain one
    ss = [_span("sweep.simulate", -2, 30, 0),
          _span("engine.iter", -2, 0, 1, 0, it=0),
          _span("engine.next_event", -2, -1, 2, 1, device_ms=0.0),
          _span("engine.check", -1, 0, 3, 1, device_ms=0.0),
          _span("engine.iter", 0, 10, 4, 0, it=1),
          _span("engine.next_event", 0, 1, 5, 4, device_ms=1.0),
          _span("engine.check", 1, 4, 6, 4, device_ms=0.5),
          _span("engine.map", 4, 10, 7, 4, device_ms=2.0),
          _span("engine.iter", 10, 16, 8, 0, it=2),
          _span("engine.next_event", 10, 12, 9, 8, device_ms=3.0),
          _span("engine.map", 12, 16, 10, 8, device_ms=4.0)]
    t = spans.stage_table(ss, its=range(1, 3))
    assert list(t) == ["next_event", "check", "map"]
    assert t["map"] == pytest.approx(dict(iters=2, host_ms=6e-6,
                                          host_ms_all=5e-6, device_ms=3.0))
    assert t["check"]["device_ms"] == 0.25
    assert spans.stage_table(ss, its=range(2, 3))["map"]["host_ms"] is None
    assert spans.stage_table(ss)["check"]["host_ms"] == pytest.approx(3e-6)
    text = spans.format_stage_table(t)
    assert "map" in text and text.splitlines()[-1].split()[-1] == "5.2500"
    assert spans.host_wait_share(ss, 0, 16) == 3 / 16
    assert spans.host_wait_share(ss, 2, 4) == 1.0


def test_idle_gaps_join_overlapping_busy_intervals():
    assert spans.idle_gaps([(5, 7), (0, 2), (1, 3), (9, 10)]) == [
        (3, 5), (7, 9)]
    assert spans.idle_gaps([]) == []


def test_idle_by_span_splits_each_gap_over_the_innermost_spans():
    # parent 0..100 with children a 10..40 and b 40..60; clock offset 1000
    ss = [_span("p", 0, 100, 0), _span("a", 10, 40, 1, 0),
          _span("b", 40, 60, 2, 0)]
    clock = (0, 1000)
    busy = [(1000 - 20, 1000 + 5), (1000 + 30, 1000 + 50),
            (1000 + 90, 1000 + 130)]
    got = spans.idle_by_span(ss, clock, busy)
    # gaps 5..30 (p 5..10, a 10..30) and 50..90 (b 50..60, p 60..90)
    assert got == pytest.approx({"p": 35e-9, "a": 20e-9, "b": 10e-9})
    busy.append((1000 - 40, 1000 - 30))       # a gap before any span
    got = spans.idle_by_span(ss, clock, busy)
    assert got[spans.NO_SPAN] == pytest.approx(10e-9)
    total = sum(b - a for a, b in spans.idle_gaps(busy)) * 1e-9
    assert math.isclose(sum(got.values()), total)


def test_idle_by_span_on_a_recorded_sweep_sums_to_the_gaps():
    _, rec, _ = recorded("flat")
    root = rec.spans[0]
    a, b = (spans.to_unix_ns(rec.clock, t) for t in (root.start, root.end))
    busy = [(a + i * (b - a) // 50, a + (2 * i + 1) * (b - a) // 100)
            for i in range(50)]
    got = spans.idle_by_span(rec.spans, rec.clock, busy)
    total = sum(y - x for x, y in spans.idle_gaps(busy)) * 1e-9
    assert math.isclose(sum(got.values()), total, rel_tol=1e-9)
    assert spans.NO_SPAN not in got
    assert "engine.map" in got


# ------------------------------------------------------------- the CLI
def test_sweep_cli_writes_the_spans(tmp_path, capsys):
    path = tmp_path / "spans.jsonl"
    sweep.main(["--device", "cpu", "--rates", "2,5", "--reps", "2",
                "--tasks", "40", "--heuristics", "FELARE", "--system",
                "paper_x2", "--dispatcher", "fair_spill", "--out",
                str(tmp_path / "out"), "--spans", str(path)])
    out = capsys.readouterr().out
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[0]["name"] == "sweep" and rows[0]["parent"] is None
    names = {r["name"] for r in rows}
    assert {"engine.map", "engine.dispatch", "engine.check",
            "sweep.to_host", "sweep.wrap"} <= names
    for r in rows:
        assert r["end_unix_ns"] - r["start_unix_ns"] == (
            r["end_ns"] - r["start_ns"]) >= 0
    assert "stage" in out and "dispatch" in out
    assert f"wrote {len(rows)} spans to {path}" in out
