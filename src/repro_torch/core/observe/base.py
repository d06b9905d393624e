"""The Observer protocol, batched (counterpart of
``repro/core/observe/base.py``).

An :class:`Observer` threads its own fixed-shape tree of tensors
(``aux``) through the engine's event loop, next to the core
:class:`~repro_torch.core.types.SimState`. Everything is batched over
the engine's leading replicate dim B: ``st.now`` is (B,), every aux leaf
leads with B, and ``halted`` returns a (B,) bool.

Lifecycle, all inside the engine's loop:

  * ``init(trace, sysarr) -> aux`` — allocate the fixed-shape state;
    ``trace`` is the batched trace (int64 task types) and ``sysarr`` the
    engine's shared tables, ``eet`` (S, M) and the powers (M,).
  * ``on_event(stage, aux, st, trace, sysarr) -> aux`` — called after
    every stage of every event, in :data:`repro_torch.core.engine.STAGES`
    order (``finalize``/``admit``/``faults``/``dispatch``/``map``/
    ``start``; ``faults`` only with a machine dynamics attached, and the
    flat system has no dispatch stage of its own but is notified there
    all the same).
  * ``finalize(aux, st) -> tree`` — shape the carried state into the
    result returned next to :class:`~repro_torch.core.types.Metrics`.

The engine computes every stage on every replicate and then keeps the
new state only where the replicate is still active; it does the same to
each aux leaf, so a finished replicate's aux stays as it was, as under
``jax.vmap`` of the reference's ``while_loop``. On such a replicate the
stages see ``now = inf``: an observer must not turn that into an index
other than through a value clamped in float (:func:`bucket_index`).

The fixed-shape-aux contract: every leaf keeps its shape and dtype
across ``init``/``on_event``, and an observer reads nothing back to the
host, so the loop stays free of host syncs.

*Dynamic* observers set ``is_dynamic = True`` and implement ``halted(aux,
st) -> (B,) bool``; the engine ORs these flags each event and, where one
is set, stops admitting work (see
:class:`repro_torch.core.observe.energy.EnergyBudget`).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


class Observer:
    """Base class for engine observers (see module docstring).

    Subclasses should be frozen dataclasses and set ``name`` to a
    unique, stable identifier: it keys the observer's slice of the
    engine's aux and of the ``(Metrics, aux)`` result.
    """

    name: str = "observer"
    #: Dynamic observers may halt admission via :meth:`halted`.
    is_dynamic: bool = False

    def with_engine_config(self, **config) -> "Observer":
        """Bind engine configuration just before simulation
        (``fairness_factor``, ``queue_size``, ``site_of_machine``,
        ``tier_of_site``). Default: return self unchanged."""
        return self

    def init(self, trace, sysarr) -> Any:
        """Allocate this observer's fixed-shape aux tree."""
        return {}

    def on_event(self, stage: str, aux: Any, st, trace, sysarr) -> Any:
        """Fold one engine stage into ``aux`` (same structure in and out)."""
        return aux

    def finalize(self, aux: Any, st) -> Any:
        """Shape the carried aux into the returned result tree."""
        return aux

    def halted(self, aux: Any, st) -> torch.Tensor:
        """(B,) bool — dynamic observers only; ORed into the engine's gate."""
        return torch.zeros_like(st.now, dtype=torch.bool)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf by leaf over nested dicts, lists and tuples
    (named tuples included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, *rest)


def bucket_index(now: torch.Tensor, width: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """(B,) int64 bucket of each replicate's event time.

    ``width`` is the bucket width, ``max(horizon / n_buckets, 1e-9)``
    (:func:`bucket_width`). The quotient is clamped in float before it
    becomes an integer, so ``now = inf`` (a finished replicate, whose
    write the engine discards) gives the last bucket, never an undefined
    cast.
    """
    q = torch.floor(now / width).clamp(0.0, float(n_buckets - 1))
    return q.to(torch.int64)


def bucket_width(horizon: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``max(horizon / n_buckets, 1e-9)`` as the reference's compiled code
    forms it: a division by a constant becomes a product with its float32
    reciprocal."""
    return (horizon * (1.0 / n_buckets)).clamp(min=1e-9)


def bucket_edges(horizon: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(B, K) right edge of each bucket."""
    k = torch.arange(1, n_buckets + 1, dtype=torch.float32,
                     device=horizon.device)
    return k * (horizon * (1.0 / n_buckets))[:, None]


def write_bucket(series: torch.Tensor, onehot: torch.Tensor,
                 value: torch.Tensor) -> torch.Tensor:
    """``series[b, bucket[b]] = value[b]``, with ``onehot`` (B, K) the
    bucket mask: a selection, so it is exact."""
    mask = onehot.reshape(onehot.shape + (1,) * (series.dim() - 2))
    return torch.where(mask, value[:, None], series)


def forward_fill(touched: torch.Tensor, series: dict, init: dict) -> dict:
    """Carry the last written bucket forward over untouched ones.

    ``series`` maps name -> (B, K, ...) tensor written at event buckets;
    ``touched`` is the (B, K) write mask; ``init`` gives the value before
    the first event. Each bucket takes the latest touched bucket at or
    before it (a ``cummax`` of touched indices), or ``init`` where there
    is none: a selection, never a sum, so it is exact.
    """
    K = touched.shape[1]
    k = torch.arange(K, device=touched.device)
    last = torch.where(touched, k, -1).cummax(dim=1).values     # (B, K)
    seen = last >= 0
    idx = last.clamp(min=0)
    out = {}
    for name, x in series.items():
        shape = idx.shape + (1,) * (x.dim() - 2)
        got = x.gather(1, idx.reshape(shape).expand(x.shape))
        fill = init[name].to(device=x.device, dtype=x.dtype)
        out[name] = torch.where(seen.reshape(shape), got, fill)
    return out
