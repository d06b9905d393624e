"""Elastic federation demo: sites leave and rejoin the fleet mid-trace
(counterpart of ``repro/launch/elastic.py``).

Drives the engine's faults subsystem (:mod:`repro_torch.core.faults`) as
an *elasticity* mechanism: a :class:`~repro_torch.core.faults.SiteOutage`
window per departing site models planned downtime (maintenance, spot
reclamation), the ``health_aware`` dispatcher re-homes admissions onto
the remaining sites through the site-health mask, and the ``health``
observer reports the capacity timeline the fleet delivered.

  PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu \
      --fleet paper_x4 --tasks 400 --rate 6 --down 1:0.25:0.5,2:0.5:0.75

``--down site:start:end`` windows are horizon fractions; the default
takes one site out for the middle half of the trace. The trace is the
port's own draw from ``--seed`` (the reference's in distribution, not in
bits). The simulation runs on ``--device`` (default: the CUDA device).
"""
from __future__ import annotations

import argparse

from repro_torch import scenarios
from repro_torch.core import engine, faults, workload
from repro_torch.core.device import resolve_device


def _parse_down(text: str):
    """``site:start:end`` comma list -> SiteOutage windows."""
    out = []
    for part in text.split(","):
        if not part.strip():
            continue
        s, a, b = part.split(":")
        out.append((int(s), float(a), float(b)))
    return tuple(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.elastic",
        description="Elastic federation: scheduled site departures, "
                    "health-masked dispatch, capacity timeline.",
    )
    ap.add_argument("--fleet", default="paper_x4",
                    help="registered fleet (default: paper_x4)")
    ap.add_argument("--tasks", type=int, default=400)
    ap.add_argument("--rate", type=float, default=6.0,
                    help="arrival rate, tasks/sec (default: 6)")
    ap.add_argument("--heuristic", default="FELARE")
    ap.add_argument("--down", default="1:0.25:0.75",
                    help="comma list of site:start:end departure windows "
                         "(horizon fractions; default: 1:0.25:0.75)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the simulation runs (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = scenarios.get_fleet(args.fleet).build()
    trace = workload.poisson_trace(
        args.seed, n_tasks=args.tasks, arrival_rate=args.rate, eet=spec.eet,
        device=dev,
    )
    outage = faults.SiteOutage(outages=_parse_down(args.down))
    m, aux = engine.simulate(
        trace, spec, heuristic=args.heuristic, dispatcher="health_aware",
        dynamics=outage, observers=("health",), device=dev,
    )
    health = {k: v.cpu().numpy() for k, v in aux["health"].items()}

    done = float(m.completed_by_type.sum())
    arrived = float(m.arrived_by_type.sum())
    ontime = done / max(arrived, 1.0)
    fleet_size = int(health["healthy"].max())
    print(f"elastic fleet {args.fleet}: {args.tasks} tasks @ "
          f"{args.rate:g}/s, departures {args.down}")
    print(f"on-time {100 * ontime:.1f}%  orphan re-dispatches "
          f"{int(health['orphans'][-1])}")
    print("\ncapacity timeline (healthy machines per bucket):")
    K = len(health["healthy"])
    for b in range(0, K, max(1, K // 16)):
        bar = "#" * int(health["healthy"][b])
        live = int(health["site_alive"][b].sum())
        print(f"  t={health['t'][b]:7.2f}  {bar:{fleet_size}s} "
              f"{int(health['healthy'][b]):3d} machines, {live} sites live")
    return {
        "ontime": ontime,
        "orphans": int(health["orphans"][-1]),
        "healthy": health["healthy"],
        "site_alive": health["site_alive"],
        "min_sites_live": int(health["site_alive"].sum(axis=1).min()),
    }


if __name__ == "__main__":
    main()
