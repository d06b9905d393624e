"""On the card: the span recorder's clock against the profiler's, and its
stage events against the host's clock. Skips without a card (decided
inside the test)."""
import dataclasses

import pytest

import portbench_common  # noqa: F401
from repro_torch.core import engine, spans
from repro_torch.experiments import runner
from repro_torch.experiments.spec import SweepSpec


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


@pytest.mark.cuda
def test_the_span_clock_maps_onto_the_profilers():
    """A span around a sleeping kernel and a synchronize: the kernel's
    device record, at ``trace_start_ns() + 1000 * start_us``, lies inside
    the span on the Unix clock, within 20 us at each end."""
    torch = _card()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.recording() as rec:
            with rec.span("sleep") as sp:
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    k = max((e for e in prof.events() if e.device_type == cuda),
            key=lambda e: e.time_range.end - e.time_range.start)
    ka = start_ns + round(k.time_range.start * 1e3)
    kb = start_ns + round(k.time_range.end * 1e3)
    sa, sb = (spans.to_unix_ns(rec.clock, t) for t in (sp.start, sp.end))
    print(f"{k.name}: starts {(ka - sa) / 1e3:.1f} us after the span, ends "
          f"{(sb - kb) / 1e3:.1f} us before it; kernel {(kb - ka) / 1e3:.1f}"
          f" us, span {(sb - sa) / 1e3:.1f} us")
    assert kb - ka > 1e6                      # the sleep ran, > 1 ms
    assert ka >= sa - 20_000 and kb <= sb + 20_000


@pytest.mark.cuda
def test_stage_events_telescope_to_the_host_window(monkeypatch):
    """A 64-iteration simulation on the card: the stage spans' card
    intervals between the first check and the one that ends the loop
    add up to the event span of that window, and to within 2 % of the
    host's time between those two synchronising checks."""
    _card()
    spec = SweepSpec(system="paper_x2", rates=(4.0, 8.0), reps=2048,
                     n_tasks=400, heuristics=("FELARE",),
                     dispatcher="fair_spill", use_fused_map=True)
    runner.run_sweep(dataclasses.replace(spec, max_steps=8), device="cuda")
    events = []
    made = spans.Recorder._event

    def keep(self):
        events.append(made(self))
        return events[-1]

    monkeypatch.setattr(spans.Recorder, "_event", keep)
    with spans.recording() as rec:
        runner.run_sweep(dataclasses.replace(spec, max_steps=64),
                         device="cuda")
    staged = [s for s in rec.spans if "device_ms" in s.attrs]
    # one chain: the loop's opening event, then one per closed stage
    assert len(events) == len(staged) + 1
    checks = [i for i, s in enumerate(staged) if s.name == "engine.check"]
    assert len(checks) == 64 // engine.CHECK_EVERY + 1
    i, j = checks[0], checks[-1]
    first, last = staged[i], staged[j]
    inside = staged[i + 1:j + 1]
    assert len(inside) > 64 * 7
    dev_ms = sum(s.attrs["device_ms"] for s in inside)
    whole = events[i + 1].elapsed_time(events[j + 1])
    assert dev_ms == pytest.approx(whole, rel=1e-3)
    host_ms = (last.end - first.end) * 1e-6
    table = spans.stage_table(rec.spans)
    print(f"stages' card ms {dev_ms:.3f}, events {whole:.3f}, host ms "
          f"{host_ms:.3f}; "
          + ", ".join(f"{k} {v['device_ms']:.4f}" for k, v in table.items()))
    assert abs(dev_ms - host_ms) <= 0.02 * host_ms
    every = sum(s.attrs["device_ms"] for s in rec.spans
                if "device_ms" in s.attrs)
    per_iter = sum(r["device_ms"] for r in table.values()) * 64
    assert every * (1 + 1e-9) >= per_iter > 0.9 * every
