"""Fault-tolerance demo on the PyTorch port: a whole site dies mid-trace —
who keeps their deadlines? (the port of ``examples/fault_tolerance.py``)

Injects a scheduled :class:`~repro_torch.core.faults.SiteOutage` (site 0
dark for the middle quarter of the trace horizon) into a 4-site
federation and compares, on one workload (common random numbers):

  * ``sticky``       — hash-affinity dispatch, blind to health: tasks
                       keep landing on the dead site and orphan out;
  * ``fair_spill``   — fairness-aware spill, accidentally robust (the
                       suffering types spill off the dead site);
  * ``health_aware`` — sticky homes + heartbeat mask: admissions route
                       around the outage the moment it starts;
  * ``health_aware`` + ``with_backup(FELARE, k=1)`` — additionally
                       fails running orphans straight over to their
                       pre-nominated backup machine.

Every run maps on the fused kernels (``map_decide`` and ``evict_stats``)
and dispatches through ``balance_scan`` on the card; on the CPU their
plain versions run.

Run: PYTHONPATH=src python examples/torch_fault_tolerance.py [--device cpu]

Without ``--device`` it runs on the CUDA card (and wants one). The
reference draws its trace with ``jax.random.PRNGKey(0)``; the port draws
it with numpy (seed 0), equal in distribution only. :func:`ontime` takes
a trace, so the reference's own arrays give the reference's numbers.
"""
import argparse

import numpy as np

from repro_torch import scenarios
from repro_torch.core import engine, faults, workload
from repro_torch.core.device import resolve_device

FLEET = "paper_x4"
N_TASKS = 400
RATE = 6.0
OUTAGE = ((0, 0.25, 0.5),)


def fleet():
    return scenarios.get_fleet(FLEET).build()


def draw_trace():
    """The demo's workload: 400 tasks at 6/s on paper_x4, numpy seed 0,
    drawn on the CPU (the engine moves it to its device), so the card and
    the CPU run the same trace."""
    return workload.poisson_trace(0, n_tasks=N_TASKS, arrival_rate=RATE,
                                  eet=fleet().eet, device="cpu")


def ontime(trace, heuristic, dispatcher, dynamics, device=None):
    """(on-time share, orphan re-dispatches) of one run on ``trace``."""
    m, aux = engine.simulate(
        trace, fleet(), heuristic=heuristic, dispatcher=dispatcher,
        dynamics=dynamics, observers=("health",), use_fused_map=True,
        device=device)
    done = float(np.sum(m.completed_by_type.cpu().numpy()))
    arrived = float(np.sum(m.arrived_by_type.cpu().numpy()))
    orphans = int(aux["health"]["orphans"].cpu().numpy()[-1])
    return done / max(arrived, 1.0), orphans


def report(trace, device=None) -> None:
    """The reference's printout for ``trace``."""
    outage = faults.SiteOutage(outages=OUTAGE)
    print("site 0 dark for the middle quarter of the horizon "
          "(paper_x4, 400 tasks @ 6/s, FELARE mapping):\n")
    base, _ = ontime(trace, "FELARE", "sticky", None, device)
    print(f"  {'no faults (reference)':42s} on-time {100 * base:5.1f}%")
    rows = [
        ("sticky (health-blind)", "FELARE", "sticky"),
        ("fair_spill", "FELARE", "fair_spill"),
        ("health_aware", "FELARE", "health_aware"),
        ("health_aware + backup k=1",
         faults.with_backup("FELARE", k=1), "health_aware"),
    ]
    for label, heuristic, dispatcher in rows:
        rate, orphans = ontime(trace, heuristic, dispatcher, outage, device)
        print(f"  {label:42s} on-time {100 * rate:5.1f}%  "
              f"orphan re-dispatches {orphans:3d}")
    print("\nhealth-aware dispatch routes admissions around the dead site;"
          "\nbackups re-home the tasks the outage caught mid-run.")


def main(argv=None, trace=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}")
        return 2
    report(draw_trace() if trace is None else trace, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
