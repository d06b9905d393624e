"""AdamW with decoupled weight decay, float32 global-norm clipping, and
float32 moments beside parameters of any dtype (counterpart of
``repro/optim/adamw.py``).

The reference's formulas, in its order, not ``torch.optim.AdamW``'s: the
gradients are taken to float32 and clipped by their global norm (the
per-leaf sums of g * g added in ``jax.tree.leaves`` order); the moments
are updated; then ``u = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p`` and
``p - lr * u`` in float32, rounded to the parameter's dtype.

Over ``DTensor`` leaves (a sharded train step) the update acts on each
rank's local shards. The global norm is the norm of the whole gradient:
each rank sums the squares of its shards, a shard that several ranks
hold (replicated over a mesh dim) counted on one of them only, and the
sum is all-reduced over the mesh before the square root; clipping acts
on that norm.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import tree as tr
from repro_torch.distributed.sharding import (all_reduce_mesh, like,
                                              owns_replica, to_local)


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
        a checkpoint's target). ``DTensor`` parameters give moments in
        their layouts and a replicated step."""
        def zeros(_, p):
            if isinstance(p, DTensor):
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        first = tr.leaves(params)[0]
        step = torch.zeros((), dtype=torch.int32,
                           device=to_local(first).device)
        if isinstance(first, DTensor):
            mesh = first.device_mesh
            step = DTensor.from_local(step, mesh,
                                      [Replicate()] * mesh.ndim,
                                      run_check=False)
        return AdamWState(step=step, mu=tr.map_named(zeros, params),
                          nu=tr.map_named(zeros, params))

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
        p_leaves = tr.leaves(params)
        mesh = (p_leaves[0].device_mesh if isinstance(p_leaves[0], DTensor)
                else None)
        step = to_local(state.step) + 1

        g_leaves = tr.leaves(grads)
        g32 = [to_local(g).to(f32) for g in g_leaves]
        sq = None
        for g, whole in zip(g32, g_leaves):
            if mesh is not None and not owns_replica(whole):
                continue
            s = torch.sum(g * g)
            sq = s if sq is None else sq + s
        if sq is None:      # this rank holds no counted shard
            sq = torch.zeros((), dtype=f32, device=step.device)
        if mesh is not None:
            all_reduce_mesh(sq, mesh)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(torch.full_like(gnorm, self.clip_norm)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)

        b1c = 1.0 - torch.pow(self.b1, step.to(f32))
        b2c = 1.0 - torch.pow(self.b2, step.to(f32))

        new_p, new_m, new_v = [], [], []
        for p, m, v, g in zip(map(to_local, p_leaves),
                              map(to_local, tr.leaves(state.mu)),
                              map(to_local, tr.leaves(state.nu)), g32):
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
            to_local(state.step).copy_(step)
            return params, state, gnorm
        return (like(params, new_p),
                AdamWState(step=like(state.step, [step]),
                           mu=like(state.mu, new_m),
                           nu=like(state.nu, new_v)),
                gnorm)

