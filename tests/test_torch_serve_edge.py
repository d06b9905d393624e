"""``examples/torch_serve_edge.py`` against ``examples/serve_edge.py`` on
the CPU.

Both examples measure the base latency of each model with
``time.perf_counter``. Here that clock is scripted for the examples' own
calls (every other caller reads the real clock), so both see one fixed
latency table; from there on every number comes from numpy draws in the
same order and from the two routers. At 30 requests the printed metrics
must be the same text, and the router's ``metrics()`` the same bits.
"""
import importlib.util
import pathlib
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# seconds per prefill: qwen1.5-0.5b, whisper-medium
LATENCY = (0.0123, 0.0871)
REQUESTS = 30


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_clock(monkeypatch, filename: str) -> None:
    """``time.perf_counter`` reads 0, 3 x LATENCY[0], 10, 10 + 3 x
    LATENCY[1] for the calls made from ``filename``: the two timing
    windows of three prefills each."""
    real = time.perf_counter
    ticks = iter([0.0, 3 * LATENCY[0], 10.0, 10.0 + 3 * LATENCY[1]])

    def clock():
        if pathlib.Path(sys._getframe(1).f_code.co_filename).name == \
                filename:
            return next(ticks)
        return real()
    monkeypatch.setattr(time, "perf_counter", clock)


def run_reference(monkeypatch, capsys, rate):
    mod = load("serve_edge")
    routers = []

    class Recording(mod.Router):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            routers.append(self)

    mod.Router = Recording
    script_clock(monkeypatch, "serve_edge.py")
    monkeypatch.setattr(sys, "argv",
                        ["serve_edge.py", "--requests", str(REQUESTS),
                         "--rate", str(rate)])
    mod.main()
    return capsys.readouterr().out.splitlines(), routers[0].metrics()


@pytest.mark.parametrize("rate", [20.0, 200.0])
def test_example_matches_the_reference(monkeypatch, capsys, rate):
    """At the example's default rate, and overloaded (requests miss their
    deadlines or are cancelled)."""
    want_lines, want = run_reference(monkeypatch, capsys, rate)
    if rate > 20:
        assert want["collective_completion_rate"] < 1
    port = load("torch_serve_edge")
    script_clock(monkeypatch, "torch_serve_edge.py")
    assert port.main(["--requests", str(REQUESTS), "--rate", str(rate),
                      "--device", "cpu"]) == 0
    got_lines = capsys.readouterr().out.splitlines()
    assert got_lines[:-1] == want_lines
    assert got_lines[-1].split() == ["device", ":", "cpu"]
    script_clock(monkeypatch, "torch_serve_edge.py")
    out = port.serve(REQUESTS, rate, device="cpu")
    assert out["base_latency_s"] == [3 * LATENCY[0] / 3,
                                     (10.0 + 3 * LATENCY[1] - 10.0) / 3]
    assert f"executed        : {out['executed']} real" in want_lines[-4]
    got = out["metrics"]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert np.asarray(g).dtype == np.asarray(w).dtype, key
        assert np.array_equal(np.asarray(g), np.asarray(w)), key


def test_example_wants_a_card_unless_told_otherwise(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = load("torch_serve_edge")
    assert port.main(["--requests", "2"]) == 2
    assert 'device="cpu"' in capsys.readouterr().out
