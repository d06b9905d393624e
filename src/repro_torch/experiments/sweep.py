"""One-command batched Monte-Carlo sweep CLI on the port.

    PYTHONPATH=src python -m repro_torch.experiments.sweep \
        --system paper --scenario bursty --rates 2,3,4,6,8 --reps 8 \
        --tasks 400 --heuristics MM,MSD,MMU,ELARE,FELARE \
        --out artifacts/sweep_torch

Runs on the CUDA device unless ``--device cpu`` is given. Rates accept a
comma list (``2,3,4.5``) or an inclusive ``start:stop:step`` range.
``--scenario`` picks a registered workload scenario
(``--list-scenarios`` prints each one's arrival x mix x deadline x
runtime x fleet composition); ``--system`` defaults to the scenario's own
fleet, or ``paper``. ``--fused-map`` runs the whole map decision (and a
federation's balance
walk) through the ``map_fused`` kernels, ``--fused-phase1`` ELARE's
Phase I through ``phase1_map``. ``--dispatcher`` picks a federation's
site-selection rule (``--list-dispatchers``). ``--dynamics`` injects a
machine-failure process (``--list-dynamics``), ``--network`` an
edge-cloud transfer-cost model (``--list-networks``; ``--list-fleets``
shows each fleet's tiers). ``--observers`` attaches engine observers
(``--list-observers``), whose results are written as ``observers.json``
and, for ``timeline``, ``timeline.csv``. ``--spans PATH`` records the
sweep's spans (:mod:`repro_torch.core.spans`), writes them to PATH as
JSON lines and prints each loop stage's host and card ms per iteration.
Unknown names and bad grids exit with an ``error:`` line and status 2.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

from repro_torch import scenarios
from repro_torch.core import (
    dispatch,
    faults,
    network,
    observe,
    policy,
    spans,
)
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.experiments.results import SweepResult
from repro_torch.experiments.runner import run_sweep
from repro_torch.experiments.spec import (
    DEFAULT_HEURISTICS,
    DEFAULT_RATES,
    SweepSpec,
    parse_rates,
)


def build_spec(argv=None) -> tuple[SweepSpec, argparse.Namespace]:
    """Parse CLI args into a SweepSpec; ``args.device`` comes back
    resolved to a ``torch.device``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.sweep",
        description="Batched Monte-Carlo sweep over "
                    "(arrival rates x replicates x heuristics), on the "
                    "PyTorch/CUDA port.",
    )
    ap.add_argument("--system", default=None,
                    help="registered fleet: " + ", ".join(
                        scenarios.list_fleets()) + " (default: the "
                        "scenario's own fleet, or paper)")
    ap.add_argument("--scenario", default="poisson",
                    help="workload scenario name (default: poisson; see "
                         "--list-scenarios)")
    ap.add_argument("--rates", default=None,
                    help="comma list '2,3,4' or inclusive range "
                         "'start:stop:step' (default: "
                         + ",".join(str(r) for r in DEFAULT_RATES) + ")")
    ap.add_argument("--reps", type=int, default=8,
                    help="replicate traces per rate (default: 8)")
    ap.add_argument("--tasks", type=int, default=400,
                    help="tasks per trace (default: 400; paper uses 2000)")
    ap.add_argument("--heuristics", default=",".join(DEFAULT_HEURISTICS),
                    help="comma list of registered policy names (default: "
                         + ",".join(DEFAULT_HEURISTICS) + "; see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list the registered scheduling policies and exit")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="list the registered workload scenarios and fleet "
                         "builders, then exit")
    ap.add_argument("--dispatcher", default="sticky",
                    help="federation site-selection rule for multi-site "
                         "systems (default: sticky; see --list-dispatchers)."
                         " Inert on single-site systems.")
    ap.add_argument("--list-dispatchers", action="store_true",
                    help="list the registered federation dispatchers and "
                         "exit")
    ap.add_argument("--dynamics", default="none",
                    help="machine-failure process to inject (default: none;"
                         " see --list-dynamics). 'none' runs the sweep "
                         "without faults.")
    ap.add_argument("--list-dynamics", action="store_true",
                    help="list the registered machine dynamics and exit")
    ap.add_argument("--network", default="none",
                    help="edge-cloud transfer-cost model (default: none; "
                         "see --list-networks). 'none' runs the sweep "
                         "with free links.")
    ap.add_argument("--list-networks", action="store_true",
                    help="list the registered network models and exit")
    ap.add_argument("--list-fleets", action="store_true",
                    help="list the registered fleet builders and exit")
    ap.add_argument("--observers", default="",
                    help="comma list of registered engine observers to "
                         "attach (e.g. timeline,task_log; see "
                         "--list-observers). Their time-resolved outputs "
                         "are written next to the sweep artifacts.")
    ap.add_argument("--list-observers", action="store_true",
                    help="list the registered engine observers and exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cv-run", type=float, default=0.1,
                    help="CV of actual runtimes around the EET (default 0.1)")
    ap.add_argument("--queue-size", type=int, default=None,
                    help="per-machine queue slots (default: system's own)")
    ap.add_argument("--fairness-factor", type=float, default=None,
                    help="Eq. 3 fairness factor f (default: system's own)")
    ap.add_argument("--fused-phase1", action="store_true",
                    help="run ELARE/FELARE Phase I through the phase1_map "
                         "kernel")
    ap.add_argument("--fused-map", action="store_true",
                    help="run the whole map decision and the dispatcher's "
                         "balance walk through the map_fused kernels "
                         "(map_decide, evict_stats, balance_scan)")
    ap.add_argument("--shard", action="store_true",
                    help="split the (rate x replicate) trace batch over "
                         "every visible CUDA device; bit-identical to the "
                         "unsharded sweep, and the plain path on one "
                         "device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions on the CPU)")
    ap.add_argument("--out", default="artifacts/sweep_torch",
                    help="artifact directory (default: artifacts/sweep_torch)")
    ap.add_argument("--spans", default=None, metavar="PATH",
                    help="record the sweep's spans (core/spans.py: the "
                         "sweep's layers and each stage of the event loop, "
                         "with its card time on CUDA), write them to PATH "
                         "as JSON lines and print the per-stage table")
    args = ap.parse_args(argv)

    if args.list:
        print_policy_list()
        raise SystemExit(0)
    if args.list_scenarios:
        print_scenario_list()
        raise SystemExit(0)
    if args.list_dispatchers:
        print_dispatcher_list()
        raise SystemExit(0)
    if args.list_observers:
        print_observer_list()
        raise SystemExit(0)
    if args.list_dynamics:
        print_dynamics_list()
        raise SystemExit(0)
    if args.list_networks:
        print_network_list()
        raise SystemExit(0)
    if args.list_fleets:
        print_fleet_list()
        raise SystemExit(0)
    heuristics = tuple(
        h.strip() for h in args.heuristics.split(",") if h.strip()
    )
    unknown = [h for h in heuristics if not policy.is_registered(h)]
    if unknown:
        ap.error(f"unknown heuristics {unknown}; registered policies: "
                 + ", ".join(policy.list_policies())
                 + " (run with --list for details)")
    if not scenarios.is_registered(args.scenario):
        ap.error(f"unknown scenario {args.scenario!r}; registered scenarios: "
                 + ", ".join(scenarios.list_scenarios())
                 + " (run with --list-scenarios for details)")
    if args.system is not None and not scenarios.is_registered_fleet(
            args.system):
        ap.error(f"unknown system {args.system!r}; registered fleets: "
                 + ", ".join(scenarios.list_fleets()))
    if not dispatch.is_registered(args.dispatcher):
        ap.error(f"unknown dispatcher {args.dispatcher!r}; registered "
                 "dispatchers: " + ", ".join(dispatch.list_dispatchers())
                 + " (run with --list-dispatchers for details)")
    if not faults.is_registered(args.dynamics):
        ap.error(f"unknown dynamics {args.dynamics!r}; registered dynamics: "
                 + ", ".join(faults.list_dynamics())
                 + " (run with --list-dynamics for details)")
    if not network.is_registered(args.network):
        ap.error(f"unknown network {args.network!r}; registered networks: "
                 + ", ".join(network.list_networks())
                 + " (run with --list-networks for details)")
    observers = tuple(
        o.strip() for o in args.observers.split(",") if o.strip())
    unknown = [o for o in observers if not observe.is_registered(o)]
    if unknown:
        ap.error(f"unknown observers {unknown}; registered observers: "
                 + ", ".join(observe.list_observers())
                 + " (run with --list-observers for details)")
    try:
        rates = parse_rates(args.rates) if args.rates else DEFAULT_RATES
        spec = SweepSpec(
            system=args.system,
            scenario=args.scenario,
            rates=rates,
            reps=args.reps,
            n_tasks=args.tasks,
            heuristics=heuristics,
            seed=args.seed,
            cv_run=args.cv_run,
            queue_size=args.queue_size,
            fairness_factor=args.fairness_factor,
            use_fused_phase1=args.fused_phase1,
            use_fused_map=args.fused_map,
            dispatcher=args.dispatcher,
            observers=observers,
            dynamics=args.dynamics,
            network=args.network,
        )
        args.device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))  # clean exit 2 instead of a traceback
    return spec, args


def print_policy_list(file=None) -> None:
    """One line per registered policy: name + composition."""
    file = file if file is not None else sys.stdout
    print(f"{'name':10s} {'phase-1 nominator':20s} {'phase-2 key':12s} "
          f"{'drop rule':15s} {'fairness':8s}", file=file)
    for name in policy.list_policies():
        d = policy.describe(name)
        print(f"{name:10s} {d.nominator:20s} {d.phase2_key:12s} "
              f"{d.drop_rule:15s} {'yes' if d.fairness else 'no':8s}",
              file=file)


def print_scenario_list(file=None) -> None:
    """One line per registered scenario: name + component composition,
    then the registered fleet builders."""
    file = file if file is not None else sys.stdout
    print(f"{'scenario':18s} {'arrivals':12s} {'mix':10s} "
          f"{'deadline':10s} {'runtime':11s} {'fleet':8s}", file=file)
    for name in scenarios.list_scenarios():
        d = scenarios.get(name).describe()
        print(f"{name:18s} {d['arrivals']:12s} {d['mix']:10s} "
              f"{d['deadline']:10s} {d['runtime']:11s} {d['fleet']:8s}",
              file=file)
    print(f"\nfleets: {', '.join(scenarios.list_fleets())}", file=file)


def print_dispatcher_list(file=None) -> None:
    """One line per registered federation dispatcher: name + description."""
    file = file if file is not None else sys.stdout
    for name in dispatch.list_dispatchers():
        print(f"{name:14s} {dispatch.describe(name)}", file=file)


def print_dynamics_list(file=None) -> None:
    """One line per registered machine dynamics: name + description."""
    file = file if file is not None else sys.stdout
    for name in faults.list_dynamics():
        print(f"{name:18s} {faults.describe(name)}", file=file)


def print_network_list(file=None) -> None:
    """One line per registered network model: name + description."""
    file = file if file is not None else sys.stdout
    for name in network.list_networks():
        print(f"{name:18s} {network.describe(name)}", file=file)


def print_fleet_list(file=None) -> None:
    """One line per registered fleet builder: name, shape, tier layout."""
    file = file if file is not None else sys.stdout
    print(f"{'fleet':14s} {'types':>5s} {'machines':>8s} {'sites':>5s} "
          f"{'tiers':14s}", file=file)
    for name in scenarios.list_fleets():
        spec = scenarios.get_fleet(name).build()
        S, M = spec.eet.shape
        tiers = spec.tiers
        label = ("flat" if max(tiers) == 0
                 else ",".join(str(t) for t in tiers))
        print(f"{name:14s} {S:5d} {M:8d} {spec.n_sites:5d} {label:14s}",
              file=file)


def print_observer_list(file=None) -> None:
    """One line per registered engine observer: name + description."""
    file = file if file is not None else sys.stdout
    for name in observe.list_observers():
        print(f"{name:22s} {observe.describe(name)}", file=file)


def print_summary(result: SweepResult, file=None) -> None:
    """Human-readable per-cell table (one line per heuristic x rate)."""
    file = file if file is not None else sys.stdout
    print(f"{'heuristic':9s} {'rate':>6s} {'ontime%':>8s} {'±ci':>6s} "
          f"{'energy':>10s} {'waste%':>7s} {'cancel%':>8s} {'miss%':>6s} "
          f"{'spread':>7s} {'jain':>6s}", file=file)
    for row in result.summary_rows():
        print(f"{row['heuristic']:9s} {row['rate']:6.2f} "
              f"{100 * row['completion_rate']:8.2f} "
              f"{100 * row['completion_rate_ci95']:6.2f} "
              f"{row['energy']:10.1f} {row['wasted_pct']:7.2f} "
              f"{row['cancelled_pct']:8.2f} {row['missed_pct']:6.2f} "
              f"{row['fairness_spread']:7.4f} {row['jain_index']:6.4f}",
              file=file)


def main(argv=None) -> SweepResult:
    spec, args = build_spec(argv)
    n = spec.n_simulations
    system_label = args.system or (
        "scenario fleet" if spec.resolve_scenario().fleet is not None
        else "paper")
    n_sites = spec.resolve_system().n_sites
    fed = (f" sites={n_sites} dispatcher={spec.dispatcher}"
           if n_sites > 1 else "")
    if spec.dynamics != "none":
        fed += f" dynamics={spec.dynamics}"
    if spec.network != "none":
        fed += f" network={spec.network}"
    shard_note = ""
    if args.shard:
        devices = sharding.sweep_devices(args.device)
        shard_note = (f" sharded over {len(devices)} devices" if devices
                      else " (--shard: single device, running unsharded)")
    print(f"sweep: {len(spec.heuristics)} heuristics x "
          f"{len(spec.rates)} rates x {spec.reps} reps "
          f"({n} traces of {spec.n_tasks} tasks) on system={system_label}"
          f" scenario={args.scenario}{fed} device={args.device}"
          f"{shard_note}",
          flush=True)
    t0 = time.perf_counter()
    with (spans.recording() if args.spans
          else contextlib.nullcontext()) as rec:
        result = run_sweep(spec, device=args.device, shard=args.shard)
    dt = time.perf_counter() - t0
    print(f"simulated {n} traces in {dt:.1f}s\n")
    print_summary(result)
    paths = result.save(args.out)
    print("\nwrote " + ", ".join(str(p) for p in paths.values()))
    if rec is not None:
        spans.write_jsonl(rec, args.spans)
        table = spans.stage_table(rec.spans)
        print("\n" + spans.format_stage_table(table))
        print(f"wrote {len(rec.spans)} spans to {args.spans}")
    return result


if __name__ == "__main__":
    main()
