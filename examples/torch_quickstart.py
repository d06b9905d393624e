"""Quickstart on the PyTorch port: the paper's headline result in one
sweep (the port of ``examples/quickstart.py``).

Simulates the Sec. VI synthetic HEC system (Table I EET, 4 machines x 4
task types, Poisson arrivals) under MM / MSD / MMU / ELARE / FELARE and
prints the energy-latency trade-off plus the fairness picture — Figs. 3,
4, 6, 7 in miniature. The whole (heuristic x rate x trace) grid runs as
one ``repro_torch.experiments.run_sweep`` on the fused map kernels
(``map_decide``, and ``evict_stats`` for FELARE's eviction planner);
ELARE runs once more on the ``phase1_map`` kernel, which must give its
counters bit for bit. On the CPU the kernels' plain versions run.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--tasks 1000]
      [--traces 8] [--scenario bursty] [--observers timeline,...]
      [--device cpu]

Without ``--device`` it runs on the CUDA card (and wants one). The
traces are the port's numpy draws, equal to the reference's in
distribution, made on the CPU whatever the device, so the card and the
CPU print the same table; :func:`sweep` takes any stack of traces, the
reference's included, and then prints the reference's table.
"""
import argparse

import numpy as np

from repro_torch import experiments, scenarios
from repro_torch.core import observe
from repro_torch.core.device import resolve_device

HEURISTICS = ("MM", "MSD", "MMU", "ELARE", "FELARE")


def sweep(spec, traces=None, device=None):
    """``run_sweep`` of ``spec`` on the map kernels, and ELARE again on
    ``phase1_map``, which must equal its row. ``traces``: a stack leading
    with (rates, reps), or ``None`` for the spec's own draw."""
    if traces is None:      # drawn on the CPU: every device runs them
        system = spec.resolve_system()
        traces = spec.resolve_scenario().stack(
            spec.seed, spec.rates, spec.reps, spec.n_tasks, system.eet,
            cv_run=spec.cv_run, n_task_types=system.n_task_types,
            device="cpu")
    res = experiments.run_sweep(experiments.replace(
        spec, use_fused_map=True), traces=traces, device=device)
    if "ELARE" in spec.heuristics:
        p1 = experiments.run_sweep(experiments.replace(
            spec, heuristics=("ELARE",), use_fused_phase1=True,
            observers=()), traces=traces, device=device)
        h = res.h_index("ELARE")
        for name, a, b in zip(res.metrics._fields, res.metrics,
                              p1.metrics):
            if not np.array_equal(a[h], b[0]):
                raise AssertionError(f"ELARE on phase1_map: {name} differs "
                                     f"from the map kernels' run")
    return res


def print_table(res) -> None:
    spec = res.spec
    print(f"{'heuristic':9s} {'rate':>5s} {'ontime%':>8s} {'waste%':>7s} "
          f"{'cancel':>7s} {'miss':>6s}  per-type completion")
    for h_i, h in enumerate(spec.heuristics):
        for r_i, rate in enumerate(spec.rates):
            m = res.metrics_for(h, rate)
            per_type = " ".join(
                f"{x:.2f}" for x in res.completion_rate_by_type[h_i, r_i])
            print(f"{h:9s} {rate:5.1f} "
                  f"{100 * res.completion_rate_pooled[h_i, r_i]:8.1f} "
                  f"{res.wasted_pct[h_i, r_i]:7.2f} "
                  f"{int(np.sum(m.cancelled_by_type)):7d} "
                  f"{int(np.sum(m.missed_by_type)):6d}  [{per_type}]")
        print()

    if "timeline" in res.aux:
        # a terminal-width sparkline of queue pressure over time, per
        # heuristic at the highest rate (replicate 0)
        blocks = " ▁▂▃▄▅▆▇█"
        print("queue occupancy over time (last rate, replicate 0):")
        for h_i, h in enumerate(spec.heuristics):
            q = res.aux["timeline"]["qlen"][h_i, -1, 0]
            top = max(1, int(q.max()))
            line = "".join(
                blocks[min(8, int(8 * v / top))] for v in q)
            print(f"  {h:9s} |{line}| peak {int(q.max())}")
        print()
    if "fairness_trajectory" in res.aux:
        print("share of time with >=1 suffered task type (last rate):")
        for h_i, h in enumerate(spec.heuristics):
            s = res.aux["fairness_trajectory"]["suffered"][h_i, -1]
            print(f"  {h:9s} {100 * float(s.any(-1).mean()):5.1f}%")
        print()

    print("Expected pattern (the paper's claims):")
    print("  * ELARE/FELARE: far lower waste% at low/moderate rates "
          "(proactive cancellation instead of deadline misses)")
    print("  * FELARE: per-type completion rates pulled together "
          "(fairness) at ~unchanged collective rate")


def make_spec(args):
    observers = tuple(
        o.strip() for o in args.observers.split(",") if o.strip())
    return experiments.SweepSpec(
        system=None,  # the scenario's own fleet, or the paper 4x4
        scenario=args.scenario, rates=tuple(args.rates), reps=args.traces,
        n_tasks=args.tasks, heuristics=HEURISTICS, observers=observers)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=800)
    ap.add_argument("--traces", type=int, default=8)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[2.0, 4.0, 8.0])
    ap.add_argument("--scenario", default="poisson",
                    choices=scenarios.list_scenarios(),
                    help="workload scenario (default: the paper's "
                         "stationary Poisson)")
    ap.add_argument("--observers", default="",
                    help="comma list of engine observers to attach "
                         f"(registered: {','.join(observe.list_observers())})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None, traces=None) -> int:
    args = parse(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}")
        return 2
    print_table(sweep(make_spec(args), traces, device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
