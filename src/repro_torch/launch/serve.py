"""Serving launcher: the FELARE-routed heterogeneous serving runtime
(counterpart of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --requests 200 --heuristic FELARE --archs qwen1.5-0.5b internlm2-1.8b

Machines come from :data:`repro_torch.cluster.profiles.FLEET`; the EET
matrix is seeded from the roofline model of each (arch x machine) and
refined online. Arrivals, types and executed latencies are drawn from
``numpy.random.default_rng(seed)``, so for the same arguments the output
is the reference's. The router's policy runs on ``--device`` (default:
the CUDA device).
"""
from __future__ import annotations

import argparse
import heapq

import numpy as np

from repro_torch.cluster import profiles
from repro_torch.cluster.router import Request, Router
from repro_torch.configs import registry


class Clock:
    """The simulated clock the router reads."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--archs", nargs="+",
                    default=["qwen1.5-0.5b", "internlm2-1.8b",
                             "whisper-medium", "xlstm-125m"])
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--heuristic", default="FELARE")
    ap.add_argument("--queue-size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the router's policy runs (default: cuda)")
    return ap.parse_args(argv)


def run(args) -> Router:
    """Drive a Router over the seeded request stream of ``args``; returns
    it with the stream served."""
    cfgs = [registry.get_config(a) for a in args.archs]
    eet = profiles.eet_from_roofline(cfgs, n_tokens=args.tokens)
    p_dyn, p_idle = profiles.power_vectors()
    mean_e = eet.mean(axis=1)
    slack = mean_e + mean_e.mean()

    clock = Clock()
    router = Router(eet, p_dyn, p_idle, queue_size=args.queue_size,
                    heuristic=args.heuristic, now_fn=clock,
                    device=args.device)

    rng = np.random.default_rng(args.seed)
    events = []
    t = 0.0
    for rid in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        tt = int(rng.integers(0, len(cfgs)))
        heapq.heappush(events, (t, 0, rid, tt))

    while events:
        tm, kind, a, b = heapq.heappop(events)
        clock.t = tm
        if kind == 0:
            started = router.on_request(Request(
                rid=a, task_type=b, arrival=tm,
                deadline=tm + float(slack[b])))
        else:
            j = a
            req = router.running[j]
            lat = tm - req.start
            started = router.on_completion(
                j, success=tm <= req.deadline, latency=lat)
        for j, req in started:
            real = float(eet[req.task_type, j]) * rng.uniform(0.85, 1.25)
            heapq.heappush(events, (clock.t + real, 1, j, 0))
    return router


def main(argv=None) -> dict:
    args = parse_args(argv)
    m = run(args).metrics()
    print(f"heuristic={args.heuristic} archs={args.archs}")
    print(f"completion={m['collective_completion_rate']:.3f} "
          f"jain={m['jain_fairness']:.3f} "
          f"energy={m['energy']:.0f}J wasted={m['energy_wasted']:.0f}J")
    for i, a in enumerate(args.archs):
        print(f"  {a:22s} cr={m['completion_rate_by_type'][i]:.3f} "
              f"({int(m['completed'][i])}/{int(m['arrived'][i])})")
    return m


if __name__ == "__main__":
    main()
