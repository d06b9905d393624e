"""End-to-end serving example on the PyTorch port: FELARE routes real
inference requests for two reduced-config models across a heterogeneous
set of serving groups (the port of ``examples/serve_edge.py``).

This is the paper's SmartSight scenario: task types are architectures (a
'face recognition'-class dense LM, qwen1.5-0.5b, and a 'speech
recognition'-class encoder-decoder, whisper-medium, both at their smoke
sizes), machines are four device groups with different simulated speed
grades, and the port's Router makes the ELARE/FELARE mapping decisions
while real ``prefill`` steps execute every started request. The
simulated-time executor scales the measured latency of each model by each
machine's speed factor, so the heterogeneity is meaningful on one device.

The numpy draws come in the reference's order (per batch its tokens, then
its frames or patches; per start the batch, then the latency jitter), so
given the same measured base latencies the router's ``metrics()`` are the
reference's bit for bit.

Run: PYTHONPATH=src python examples/torch_serve_edge.py [--requests 120] \
         [--heuristic FELARE] [--rate 20] [--device cpu]

Without ``--device`` it runs on the CUDA card (and wants one).
"""
import argparse
import heapq
import time

import numpy as np
import torch

from repro_torch.cluster.router import Request, Router
from repro_torch.configs import registry
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import make_serve_steps

ARCHS = ("qwen1.5-0.5b", "whisper-medium")
MAX_SEQ = 48
SPEED = np.array([1.0, 2.5, 0.6, 1.4])
P_DYN = np.array([170.0, 520.0, 80.0, 210.0], np.float32)


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make_batch(cfg, rng, device):
    """One request's inputs: 16 tokens, and 16 frames (audio) or the
    patches (vlm) at 0.1 N(0, 1), drawn from ``rng`` in that order."""
    B, S = 1, 16
    b = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32)}
    if cfg.family == "audio":
        b["frames"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.d_model)), dtype=torch.float32
        ) * 0.1
    if cfg.family == "vlm":
        b["patches"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_patches, cfg.d_model)),
            dtype=torch.float32) * 0.1
    return {k: v.to(device) for k, v in b.items()}


def serve(requests=120, rate=20.0, heuristic="FELARE", seed=0,
          device=None) -> dict:
    """Route and execute a Poisson stream of ``requests``. Returns the
    router's metrics, the count of completions (``executed``, as the
    reference counts them), the prefill calls made per task type
    (profiling and executions), the measured base latencies (s) and the
    device."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed)

    # two ML applications (task types)
    cfgs = [registry.get_smoke_config(a) for a in ARCHS]
    params = [tf.init(cfg, seed=0, device=dev) for cfg in cfgs]
    steps = [make_serve_steps(cfg, device=dev) for cfg in cfgs]

    # measure the base latency per task type once (the 'profiling' run)
    base_lat, calls = [], [4] * len(ARCHS)
    for cfg, p, (prefill, _) in zip(cfgs, params, steps):
        batch = make_batch(cfg, rng, dev)
        prefill(p, batch, max_seq=MAX_SEQ)  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            prefill(p, batch, max_seq=MAX_SEQ)
            sync()
        base_lat.append((time.perf_counter() - t0) / 3)

    # heterogeneous machines: speed factor + power (the fleet profile)
    p_idle = P_DYN * 0.1
    eet = np.asarray(base_lat, np.float32)[:, None] / SPEED[None, :]
    mean_e = eet.mean(axis=1)
    deadline_slack = mean_e + mean_e.mean()

    clock = SimClock()
    router = Router(eet, P_DYN, p_idle, heuristic=heuristic, queue_size=2,
                    now_fn=clock, device=dev)

    # Poisson request stream
    events = []  # (time, kind, payload)
    t = 0.0
    for rid in range(requests):
        t += rng.exponential(1.0 / rate)
        tt = int(rng.integers(0, len(ARCHS)))
        heapq.heappush(events, (t, 0, rid, tt))

    n_exec = 0
    while events:
        tm, kind, a, b = heapq.heappop(events)
        clock.t = tm
        if kind == 0:  # arrival
            rid, tt = a, b
            req = Request(rid=rid, task_type=tt, arrival=tm,
                          deadline=tm + float(deadline_slack[tt]))
            started = router.on_request(req)
        else:          # completion on machine a
            j = a
            req = router.running[j]
            lat = tm - req.start
            ok = tm <= req.deadline
            started = router.on_completion(j, success=ok, latency=lat)
            n_exec += 1
        for j, req in started:
            # execute the real model once (machine speed scales sim time)
            cfg, p, (prefill, _) = (cfgs[req.task_type],
                                    params[req.task_type],
                                    steps[req.task_type])
            prefill(p, make_batch(cfg, rng, dev), max_seq=MAX_SEQ)
            sync()
            calls[req.task_type] += 1
            sim_lat = float(base_lat[req.task_type] / SPEED[j]
                            * rng.uniform(0.9, 1.1))
            heapq.heappush(events, (clock.t + sim_lat, 1, j, 0))
    return {"metrics": router.metrics(), "executed": n_exec,
            "prefill_calls": calls, "base_latency_s": base_lat,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--heuristic", default="FELARE",
                    choices=["FELARE", "ELARE", "MM", "MSD", "MMU"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}")
        return 2
    out = serve(args.requests, args.rate, args.heuristic, args.seed, device)
    m = out["metrics"]
    print(f"heuristic={args.heuristic} requests={args.requests} "
          f"rate={args.rate}/s")
    print(f"  completion rate : {m['collective_completion_rate']:.3f}")
    print(f"  per-type rates  : "
          + " ".join(f"{x:.2f}" for x in m["completion_rate_by_type"]))
    print(f"  Jain fairness   : {m['jain_fairness']:.3f}")
    print(f"  energy (J, sim) : {m['energy']:.1f} "
          f"(wasted {m['energy_wasted']:.1f})")
    print(f"  executed        : {out['executed']} real inference calls")
    print(f"  adapted EET     :\n{np.round(m['eet'], 4)}")
    print(f"  device          : {out['device']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
