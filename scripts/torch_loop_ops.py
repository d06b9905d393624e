#!/usr/bin/env python3
"""Count the PyTorch ops one batched iteration of the port's event loop
dispatches, with and without engine observers, machine faults and a
network, and on the workload scenarios and synthetic fleets, on the CPU.

    PYTHONPATH=src python scripts/torch_loop_ops.py

Every op that reaches the dispatcher is counted, views and metadata
queries excepted, over 64 iterations of the first steps of a sweep (two
rates x two replicates of 300 tasks) and divided by 64 after the
simulator's set-up (the same call at ``max_steps=0``) is taken off. On
the card most such ops launch one kernel, so the count predicts the
kernels per iteration that ``chip_smoke.py``'s ``profile`` phase
measures; it is a prediction, not a device measurement.
"""
from __future__ import annotations

import collections

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import scenarios
from repro_torch.core import (
    dispatch,
    engine,
    faults,
    network,
    observe,
    policy,
)

STEPS = 64
NOT_COUNTED = {
    "view", "_unsafe_view", "expand", "reshape", "slice", "select",
    "unsqueeze", "squeeze", "permute", "transpose", "t", "alias",
    "as_strided", "detach", "lift_fresh", "unbind", "split", "narrow",
    "diagonal", "_local_scalar_dense", "item", "size", "stride",
}
ALL_FOUR = ("task_log", "timeline", "fairness_trajectory", "energy_budget")
# The dynamics of chip_smoke.py's faults phase: two site outages, churn,
# one straggler at twice the runtime.
OUTAGE = faults.SiteOutage(outages=((0, 0.25, 0.5), (3, 0.5, 0.75)))
CHURN = faults.BernoulliUpDown(p_fail=0.02, p_recover=0.2, seed=0)
STRAGGLER = faults.Degrade(factor=2.0, machines=(1,))
HARSH = network.Tiered(latency=((0.05, 1.0, 6.0), (1.0, 0.05, 4.0),
                                (6.0, 4.0, 0.0)),
                       energy=((0.1, 0.5, 2.0), (0.5, 0.1, 1.0),
                               (2.0, 1.0, 0.0)))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in NOT_COUNTED and not name.startswith("is_"):
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def ops_per_iteration(system: str, select_fn, observers=(),
                      dispatcher=None, dynamics=None, network=None,
                      scenario: str = "poisson") -> float:
    spec = scenarios.get_fleet(system).build()
    F = spec.n_sites
    traces = scenarios.get(scenario).stack(0, (2.0 * F, 8.0 * F), 2, 300,
                                           spec.eet, device="cpu")
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    counts = []
    for steps in (STEPS, 0):
        sim = engine.make_simulator(
            select_fn, spec.as_torch("cpu"), queue_size=spec.queue_size,
            max_steps=steps, observers=observers, dispatcher=dispatcher,
            site_of_machine=spec.site_of_machine, dynamics=dynamics,
            network=network, tier_of_site=spec.tier_of_site)
        mode = _Count()
        with mode:
            sim(flat)
        counts.append(sum(mode.ops.values()))
    return (counts[0] - counts[1]) / STEPS


def main() -> None:
    felare = policy.with_fused_map("FELARE")
    fair_spill = dispatch.with_fused_balance("fair_spill")
    runs = (
        ("flat FELARE", "paper", felare, (), None),
        ("flat FELARE, all four observers", "paper", felare, ALL_FOUR,
         None),
        ("flat FELARE, task_log", "paper", felare, ("task_log",), None),
        ("flat ELARE on phase1_map", "paper",
         policy.with_fused_phase1("ELARE"), (), None),
        ("paper_x8 FELARE + fair_spill", "paper_x8", felare, (),
         fair_spill),
        ("paper_x8 FELARE + fair_spill, task_log and per-site timeline",
         "paper_x8", felare, ("task_log", observe.Timeline(per_site=True)),
         fair_spill),
    )
    for label, system, select_fn, observers, dispatcher in runs:
        n = ops_per_iteration(system, select_fn, observers, dispatcher)
        print(f"{label:62s} {n:8.2f}")
    health_aware = dispatch.with_fused_balance("health_aware")
    faulted = (
        ("paper_x8 FELARE + health_aware, outage", "paper_x8", felare, (),
         health_aware, OUTAGE),
        ("paper_x8 FELARE + health_aware, outage, task_log and health",
         "paper_x8", felare, ("task_log", "health"), health_aware, OUTAGE),
        ("paper_x8 FELARE + fair_spill, churn", "paper_x8", felare, (),
         fair_spill, CHURN),
        ("paper_x2 with_backup(FELARE, 1) + health_aware, churn",
         "paper_x2", policy.with_fused_map(faults.with_backup("FELARE", 1)),
         (), health_aware, CHURN),
        ("flat ELARE on phase1_map, straggler", "paper",
         policy.with_fused_phase1("ELARE"), (), None, STRAGGLER),
    )
    for label, system, select_fn, observers, dispatcher, dyn in faulted:
        n = ops_per_iteration(system, select_fn, observers, dispatcher, dyn)
        print(f"{label:62s} {n:8.2f}")
    # chip_smoke.py's network phase: tiered_x4 under the harsh tiered
    # matrices of benchmarks/ablations.py::tiered_network
    tier_aware = dispatch.with_fused_balance("tier_aware")
    networked = (
        ("tiered_x4 FELARE + fair_spill, no network", felare, (),
         fair_spill, None),
        ("tiered_x4 ELARE + tier_aware, harsh tiered",
         policy.with_fused_map("ELARE"), (), tier_aware, HARSH),
        ("tiered_x4 FELARE + tier_aware, harsh tiered", felare, (),
         tier_aware, HARSH),
        ("tiered_x4 FELARE + fair_spill, harsh tiered", felare, (),
         fair_spill, HARSH),
        ("tiered_x4 FELARE + fair_spill, harsh tiered, task_log, network",
         felare, ("task_log", "network"), fair_spill, HARSH),
    )
    for label, select_fn, observers, dispatcher, net in networked:
        n = ops_per_iteration("tiered_x4", select_fn, observers, dispatcher,
                              network=net)
        print(f"{label:62s} {n:8.2f}")
    # chip_smoke.py's scenarios phase: the synthetic fleets' shapes
    sticky_by_type = dispatch.Sticky(by_type=True)
    fleets = (
        ("paper FELARE, bursty", "paper", felare, None, "bursty"),
        ("paper FELARE, bursty-heavy-tail", "paper", felare, None,
         "bursty-heavy-tail"),
        ("cvb FELARE (wide-fleet)", "cvb", felare, None, "wide-fleet"),
        ("cvb ELARE on phase1_map (wide-fleet)", "cvb",
         policy.with_fused_phase1("ELARE"), None, "wide-fleet"),
        ("range FELARE", "range", felare, None, "poisson"),
        ("mixed_sites FELARE + least_queued", "mixed_sites", felare,
         dispatch.with_fused_balance("least_queued"), "poisson"),
        ("mixed_sites FELARE + min_eet", "mixed_sites", felare, "min_eet",
         "poisson"),
        ("mixed_sites ELARE + least_queued on phase1_map", "mixed_sites",
         policy.with_fused_phase1("ELARE"),
         dispatch.with_fused_balance("least_queued"), "poisson"),
        ("paper_x2 FELARE + sticky by type (federated-skew)", "paper_x2",
         felare, sticky_by_type, "federated-skew"),
        ("paper_x2 FELARE + fair_spill (federated-skew)", "paper_x2",
         felare, fair_spill, "federated-skew"),
    )
    for label, system, select_fn, dispatcher, scenario in fleets:
        n = ops_per_iteration(system, select_fn, (), dispatcher,
                              scenario=scenario)
        print(f"{label:62s} {n:8.2f}")


if __name__ == "__main__":
    main()
