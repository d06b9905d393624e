"""The benchmark's one trace generator: a mix file's parameters in, a
(rates x replicates) stack of task traces out.

The ``poisson`` mix is the paper's Sec. VI-A workload, the arithmetic of
the program's ``poisson`` scenario: Exp(1) gaps over the rate summed
into arrival times, uniform task types, Eq. 4 deadlines (arrival plus
the type's mean EET plus the table's mean EET) and Gamma runtimes of
mean EET[type, machine] and coefficient of variation ``cv_run``. As in
the program's sweeps, replicate ``k`` has the same draws at every rate
(common random numbers): only its arrival times see the rate.

Every time is then rounded to a multiple of ``1 / dyadic`` seconds, so
that sums of times are exact in float32 and do not depend on their
order. The draws come from a ``torch.Generator`` on the device that
runs the cell, seeded from ``(seed, batch)``, a few large calls per
batch; the program receives only the arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def batch_seed(seed: int, batch: int) -> int:
    """A 63-bit generator seed for batch ``batch`` of run seed ``seed``."""
    words = np.random.SeedSequence(
        [int(seed) % 2**64, int(batch) % 2**64]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _dyadic(x: torch.Tensor, scale: int) -> torch.Tensor:
    return (torch.round(x.double() * scale) / scale).float()


def stack(mix: dict, eet: np.ndarray, seed: int, batch: int,
          device) -> tuple:
    """The trace stack of batch ``batch``: ``(arrival, task_type,
    deadline, exec_actual)`` with leading dims (R, K): float32, int32,
    float32, float32 (the last (R, K, N, M))."""
    if mix["scenario"] != "poisson":
        raise ValueError(f"no generator for scenario {mix['scenario']!r}")
    rates = torch.tensor([float(r) for r in mix["rates"]],
                         dtype=torch.float64, device=device)
    K, N = int(mix["reps"]), int(mix["n_tasks"])
    cv = float(mix["cv_run"])
    scale = int(mix["dyadic"])
    eet_t = torch.as_tensor(np.asarray(eet, np.float32), device=device)
    S, M = eet_t.shape
    R = rates.shape[0]
    g = torch.Generator(device=device)
    g.manual_seed(batch_seed(seed, batch))
    gaps = torch.empty((K, N), dtype=torch.float32,
                       device=device).exponential_(1.0, generator=g)
    types = torch.randint(0, S, (K, N), generator=g, device=device,
                          dtype=torch.int64)
    shape = torch.full((K, N, M), 1.0 / (cv * cv), dtype=torch.float32,
                       device=device)
    draw = torch._standard_gamma(shape, generator=g)
    del shape
    mean = eet_t[types]                                        # (K, N, M)
    exec_actual = _dyadic(draw * (mean * np.float32(cv * cv)), scale)
    del draw, mean
    arrival = _dyadic(torch.cumsum(gaps.double()[None] / rates[:, None, None],
                                   dim=-1), scale)            # (R, K, N)
    e_bar_i = eet_t.double().mean(dim=1)                       # (S,)
    slack = e_bar_i[types] + e_bar_i.mean()                    # (K, N)
    deadline = _dyadic(arrival.double() + slack[None], scale)
    types32 = types.to(torch.int32)
    return (arrival.contiguous(),
            types32[None].expand(R, K, N).contiguous(),
            deadline.contiguous(),
            exec_actual[None].expand(R, K, N, M).contiguous())

