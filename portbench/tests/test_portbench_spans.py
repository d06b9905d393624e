"""The reader of the program's host issue counters, on made-up counters
and on a program without them; and the recorder on around a whole run
leaving every reader's value as it was."""
import json
import sys
import types

import pytest

import portbench_common  # noqa: F401
from portbench import cells, harness
from repro_torch.core import engine, spans

SMALL = dict(reps=4, n_tasks=120, warmup_steps=5, trace_steps=32,
             check_per_rate=2)
WORKLOAD = "paperx8.felare_fairspill"


def test_host_issue_reader_on_made_up_counters(monkeypatch):
    monkeypatch.setattr(engine, "COUNTS", dict(
        loop_iterations=6400, checks=210, check_wait_ns=9 * 10**9,
        issue_ns=1_050_000_000, issue_iters=200))
    obs = types.SimpleNamespace()
    assert cells.reader("host_issue_ms_per_iter")(obs) == 5.25


def test_host_issue_reader_without_the_counters(monkeypatch):
    read = cells.reader("host_issue_ms_per_iter")
    obs = types.SimpleNamespace()
    # a program that keeps only its iteration count, as before the
    # counters were added
    monkeypatch.setattr(engine, "COUNTS", {"loop_iterations": 800})
    assert read(obs) is None
    # a program that ran no check yet
    monkeypatch.setattr(engine, "COUNTS", dict.fromkeys(
        ("loop_iterations", "checks", "check_wait_ns", "issue_ns",
         "issue_iters"), 0))
    assert read(obs) is None
    # no program loaded at all
    monkeypatch.delitem(sys.modules, "repro_torch.core.engine")
    assert read(obs) is None


def _run(capsys, seed):
    rc = harness.run(["--workload", WORKLOAD, "--seed", str(seed),
                      "--seconds", "0", "--trace", "1"], device="cpu",
                     mix_overrides=SMALL)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_recorder_on_changes_no_reading(capsys):
    """On the CPU at a tiny size: a traced run inside ``recording()``
    reports the same metrics as one without, equal where they do not
    time anything, and the same check."""
    off = _run(capsys, 2147483693)
    with spans.recording() as rec:
        on = _run(capsys, 2147483693)
    assert {s.name for s in rec.spans} >= {"sweep", "engine.map",
                                           "engine.dispatch"}
    assert on["metrics"].keys() == off["metrics"].keys()
    assert "host_issue_ms_per_iter" in on["metrics"]
    for name in ("iters_per_batch", "launches_per_iter", "peak_mem_gib"):
        if name in off["metrics"]:
            assert on["metrics"][name] == off["metrics"][name], name
    assert on["correct"] and off["correct"]
    assert on["checks"] == off["checks"]
    assert on["attempted"] == off["attempted"]
