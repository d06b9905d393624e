"""Fairness measure over task types (Sec. V, Algorithm 4), in PyTorch.

Counterpart of ``repro/core/fairness.py``. Every function reduces over
the last (type) axis and keeps any leading batch dims.
"""
from __future__ import annotations

import torch

from repro_torch.core import equations


def completion_rates(completed_by_type, arrived_by_type):
    """cr_i = on-time completions of type i / arrivals of type i (so far).

    Types with no arrivals yet report rate 1.0 (they cannot have suffered).
    """
    rate = completed_by_type.to(torch.float32) / arrived_by_type.clamp(
        min=1).to(torch.float32)
    return torch.where(arrived_by_type > 0, rate, torch.ones_like(rate))


def suffered_types(completed_by_type, arrived_by_type, fairness_factor,
                   min_arrivals: int = 1):
    """Algorithm 4 — the suffered-task-type mask (rate <= Eq. 3 limit)."""
    cr = completion_rates(completed_by_type, arrived_by_type)
    eps = equations.fairness_limit(cr, fairness_factor)
    judged = arrived_by_type >= min_arrivals
    return (cr <= eps[..., None]) & judged


def jain_index(values):
    """Jain's fairness index over per-type completion rates (1.0 = fair)."""
    v = values.to(torch.float32)
    s1 = equations.seq_sum(v)
    s2 = equations.seq_sum(v * v)
    n = v.shape[-1]
    return torch.where(s2 > 0, s1 * s1 / (n * s2), torch.ones_like(s1))
