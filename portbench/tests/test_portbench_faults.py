"""A run with the timed path broken underneath comes out not correct:
the harness driven on the CPU at a tiny size (its look for a card
skipped), once for each fault a sweep cell can have. One card, so no
exchange between cards to leave out."""
import json

import numpy as np
import pytest

from portbench_common import ROOT  # noqa: F401
from portbench import harness
from repro_torch.core import engine
from repro_torch.core.types import Metrics
from repro_torch.experiments import runner

SMALL = dict(reps=2, n_tasks=40, warmup_steps=5, trace_steps=32,
             check_per_rate=2)


def _run(capsys, workload="paper4x4.felare_fused"):
    rc = harness.run(["--workload", workload, "--seed", "2147483659",
                      "--seconds", "0", "--trace", "0"], device="cpu",
                     mix_overrides=SMALL)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    line = _run(capsys)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"


def _state_unchanged(monkeypatch):
    """The map stage hands its state back as it came: no task is mapped
    (the loop still ends, at its step cap)."""
    monkeypatch.setattr(engine, "_stage_map", lambda st, *a, **k: st)


def _half_batch(monkeypatch):
    real = runner.run_sweep

    def half(spec, *, traces, **kw):
        res = real(spec, traces=traces, **kw)
        m = res.metrics
        K = spec.reps
        res.metrics = Metrics(*(np.concatenate(
            [x[:, :, :K // 2], x[:, :, :K - K // 2]], axis=2) for x in m))
        return res
    monkeypatch.setattr(runner, "run_sweep", half)


def _altered_counter(monkeypatch):
    real = engine._metrics

    def altered(st, sysarr):
        m = real(st, sysarr)
        c, mi = m.completed_by_type.clone(), m.missed_by_type.clone()
        c[:, 0] += 1
        mi[:, 0] -= 1
        return m._replace(completed_by_type=c, missed_by_type=mi)
    monkeypatch.setattr(engine, "_metrics", altered)


def _altered_energy(monkeypatch):
    real = engine._metrics

    def altered(st, sysarr):
        m = real(st, sysarr)
        return m._replace(energy_dynamic=m.energy_dynamic * 1.01)
    monkeypatch.setattr(engine, "_metrics", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _altered_counter, _altered_energy],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", ["paper4x4.felare_fused",
                                      "paperx8.felare_fairspill"])
def test_fault_is_caught(monkeypatch, capsys, fault, workload):
    fault(monkeypatch)
    line = _run(capsys, workload)
    assert not line["correct"], line["checks"]
    assert line["failed"] > 0
