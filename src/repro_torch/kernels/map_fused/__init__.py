"""Fused map-decision kernels: ``map_decide`` and ``evict_stats``.

Counterpart of ``repro/kernels/map_fused`` for the flat path (the
federation's ``balance_scan`` is not ported yet). Wrappers and plain
versions live in :mod:`repro_torch.kernels.map_fused.ops`.
"""
from repro_torch.kernels.map_fused.ops import (
    LAUNCHES,
    evict_stats,
    evict_stats_plain,
    map_decide,
    map_decide_plain,
)

__all__ = ["LAUNCHES", "evict_stats", "evict_stats_plain", "map_decide",
           "map_decide_plain"]
