"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis
(counterpart of ``repro/distributed/pipeline.py``).

The layer stack is split into ``P`` stages, one per rank of the axis; M
microbatches stream through with the classic (M + P - 1)-tick schedule.
Each tick every stage applies its layers and hands its output to the
next stage (a send/recv pair, :class:`_Shift`, whose backward hands the
gradient to the previous stage); the last stage's outputs are shared
with every rank by a sum. The schedule is differentiable in the stage
parameters, as the reference's is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import map_path


def _exchange(send, to, recv_like, frm, group) -> torch.Tensor:
    """Send ``send`` to global rank ``to`` and receive a tensor shaped like
    ``recv_like`` from ``frm`` (either may be ``None``); zeros when
    nothing is received."""
    out = torch.zeros_like(recv_like)
    ops = []
    if send is not None and to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage s's output goes to stage s + 1; stage s receives stage
    s - 1's (stage 0 receives zeros). Backward: the gradient of what was
    received goes back to stage s - 1, and the gradient of what was sent
    comes from stage s + 1.

    ``token`` is a scalar threaded through the ticks, so that every
    rank's autograd runs the shifts' backwards one tick after another in
    reverse order (the sends and receives of two ranks pair up in that
    order), and runs each of them even where the received value feeds
    nothing.
    """

    @staticmethod
    def forward(ctx, y, token, prev, nxt, group):
        ctx.peers = (prev, nxt, group)
        return _exchange(y, nxt, y, prev, group), token.clone()

    @staticmethod
    def backward(ctx, g_recv, g_token):
        prev, nxt, group = ctx.peers
        g_y = _exchange(g_recv, prev, g_recv, nxt, group)
        return g_y, g_token, None, None, None


class _ReplicatedSum(torch.autograd.Function):
    """The sum over the group of each rank's ``x``, the same on every
    rank. The result is replicated, so its gradient (the same on every
    rank) is each rank's input gradient as it is: the transpose of the
    reference's ``psum`` into a replicated output. (``torch.distributed
    .nn.functional.all_reduce`` sums the ranks' gradients instead, which
    counts a replicated loss once per rank.)"""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe(stage_fn, mesh, axis: str = "pipe"):
    """Build a pipelined apply.

    ``stage_fn(stage_params, x) -> x'``, the per-stage transform (e.g. a
    loop over the stage's layers). ``stacked_params`` leaves have a
    leading dim P (stage-major stacking, :func:`stack_stages`): whole
    tensors (each rank takes its stage's row, differentiably) or
    ``DTensor`` s split over ``axis`` on that dim. ``xs``: (M, ...)
    microbatches, the same on every rank.

    Returns ``run(stacked_params, xs) -> (M, ...)`` outputs on every
    rank, numerically identical to applying all stages in turn. Every
    rank of the axis calls it, and its backward.
    """
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages = len(ranks)
    sid = mesh.get_local_rank(axis)
    prev = ranks[sid - 1] if sid > 0 else None
    nxt = ranks[sid + 1] if sid < n_stages - 1 else None
    last = sid == n_stages - 1

    def local(_, a):
        if isinstance(a, DTensor):
            return a.to_local()[0]
        return a[sid]

    def run(stacked_params, xs):
        params = map_path(local, stacked_params)
        M = xs.shape[0]
        recv = torch.zeros_like(xs[0])
        token = torch.zeros((), dtype=xs.dtype, device=xs.device,
                            requires_grad=torch.is_grad_enabled())
        outs = [torch.zeros_like(xs[0]) for _ in range(M)]
        for t in range(M + n_stages - 1):
            # stage 0 ingests microbatch t (if any); others take the ring
            x_in = xs[t if t < M else 0] if sid == 0 else recv
            y = stage_fn(params, x_in)
            # the last stage emits microbatch t - (P - 1)
            out_idx = t - (n_stages - 1)
            if last and out_idx >= 0:
                outs[out_idx] = y
            recv, token = _Shift.apply(y, token, prev, nxt, group)
        outs = torch.stack(outs) + token * 0
        return _ReplicatedSum.apply(outs, group)

    return run


def stack_stages(layer_params, n_stages: int):
    """(L, ...) layer-stacked params -> (P, L/P, ...) stage-major
    stacking."""
    def resh(_, a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages}")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return map_path(resh, layer_params)
