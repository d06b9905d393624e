"""AdamW with decoupled weight decay, float32 global-norm clipping, and
float32 moments beside parameters of any dtype (counterpart of
``repro/optim/adamw.py``).

The reference's formulas, in its order, not ``torch.optim.AdamW``'s: the
gradients are taken to float32 and clipped by their global norm (the
per-leaf sums of g * g added in ``jax.tree.leaves`` order); the moments
are updated; then ``u = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p`` and
``p - lr * u`` in float32, rounded to the parameter's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import tree as tr


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 ()
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | None = 3e-4        # None -> a rate is required at update
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments in float32 and a zero step, on the parameters'
        device (``meta`` parameters give a ``meta`` state: the shapes of
        a checkpoint's target)."""
        def zeros(_, p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tr.leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tr.map_named(zeros, params), nu=tr.map_named(zeros, params))

    def update(self, grads, state: AdamWState, params, lr=None, *,
               inplace: bool = False):
        """-> (new params, new state, the global norm of ``grads`` before
        clipping). ``lr`` (a float or a float32 tensor) overrides
        ``self.lr``. ``inplace=True`` writes the new parameters and
        moments into the given tensors (the counterpart of buffer
        donation) and returns those same trees."""
        lr = self.lr if lr is None else lr
        if lr is None:
            raise ValueError("AdamW(lr=None) needs lr at update (pass a "
                             "schedule's rate)")
        f32 = torch.float32
        step = state.step + 1

        g32 = [g.to(f32) for g in tr.leaves(grads)]
        sq = None
        for g in g32:
            s = torch.sum(g * g)
            sq = s if sq is None else sq + s
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(torch.full_like(gnorm, self.clip_norm)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)

        b1c = 1.0 - torch.pow(self.b1, step.to(f32))
        b2c = 1.0 - torch.pow(self.b2, step.to(f32))

        new_p, new_m, new_v = [], [], []
        for p, m, v, g in zip(tr.leaves(params), tr.leaves(state.mu),
                              tr.leaves(state.nu), g32):
            g = g * scale
            m1 = self.b1 * m + (1 - self.b1) * g
            v1 = self.b2 * v + (1 - self.b2) * g * g
            u = (m1 / b1c) / (torch.sqrt(v1 / b2c) + self.eps)
            u = u + self.weight_decay * p.to(f32)
            p1 = (p.to(f32) - lr * u).to(p.dtype)
            if inplace:
                p.copy_(p1)
                m.copy_(m1)
                v.copy_(v1)
            else:
                new_p.append(p1)
                new_m.append(m1)
                new_v.append(v1)
        if inplace:
            state.step.copy_(step)
            return params, state, gnorm
        return (tr.unflatten_like(params, new_p),
                AdamWState(step=step, mu=tr.unflatten_like(state.mu, new_m),
                           nu=tr.unflatten_like(state.nu, new_v)),
                gnorm)
