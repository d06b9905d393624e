"""Ring attention: sequence-parallel exact attention over a mesh axis
(counterpart of ``repro/distributed/ring_attention.py``).

The (B, S, H, hd) activations are split over the sequence on one mesh
axis; each rank keeps its queries and passes its K/V shard to the next
rank of the ring (``batch_isend_irecv``) while it accumulates its
queries' online softmax in float32: exact attention with S/P-sized
working sets.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import Layout, local_chunk, mesh_device


def _seq_layout(mesh, axis: str, ndim: int) -> Layout:
    return Layout(mesh, (None, axis) + (None,) * (ndim - 2))


def _local_seq(x, mesh, axis: str) -> torch.Tensor:
    """This rank's sequence shard of ``x`` (a DTensor in any layout, or
    the whole tensor)."""
    lay = _seq_layout(mesh, axis, x.ndim)
    if isinstance(x, DTensor):
        if tuple(x.placements) != lay.placements:
            x = x.redistribute(mesh, lay.placements)
        return x.to_local()
    return local_chunk(torch.as_tensor(x), lay).to(mesh_device(mesh))


def _rotate(t: torch.Tensor, group, ranks: list, i: int) -> torch.Tensor:
    """``t`` sent to ring slot i + 1; returns what slot i - 1 sent."""
    n = len(ranks)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[(i + 1) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q, k, v, mesh, axis: str = "model", *, causal=True):
    """q, k, v: (B, S, H, hd) with S divisible by the ``axis`` size:
    ``DTensor`` s, or the whole tensors on every rank. Every rank of the
    mesh calls it.

    Returns a (B, S, H, hd) ``DTensor`` split over the sequence on
    ``axis``, numerically equal to full softmax attention. GQA: pass k/v
    already head-repeated (or Hkv == H).
    """
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    i = mesh.get_local_rank(axis)
    ql, kr, vr = (_local_seq(x, mesh, axis) for x in (q, k, v))
    B, Sl, H, hd = ql.shape
    dev = ql.device
    scale = hd ** -0.5
    qf = ql.to(torch.float32) * scale
    q_pos = i * Sl + torch.arange(Sl, device=dev)

    m = torch.full((B, H, Sl), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sl, hd), dtype=torch.float32, device=dev)
    for r in range(n):
        # kr holds the shard that started at ring slot (i - r)
        src = (i - r) % n
        k_pos = src * Sl + torch.arange(Sl, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr.to(torch.float32))
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vr.to(torch.float32))
        m = m_new
        if r < n - 1:       # the last shard is not passed on
            kr = _rotate(kr, group, ranks, i)
            vr = _rotate(vr, group, ranks, i)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.transpose(1, 2).to(ql.dtype).contiguous()
    return DTensor.from_local(out, mesh,
                              _seq_layout(mesh, axis, 4).placements,
                              run_check=False)
