"""Learning-rate schedules: pure functions of the step, in float32
(counterpart of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(base_lr: float, warmup: int, total: int,
                       min_frac: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * base_lr`` at ``total``. The step may be an int or
    a tensor (the optimizer's counter, on its device); the rate is a
    float32 tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                              * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def constant(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
