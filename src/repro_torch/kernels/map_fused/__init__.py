"""Fused map-decision kernels: ``map_decide``, ``evict_stats`` and the
dispatcher's ``balance_scan``.

Counterpart of ``repro/kernels/map_fused``. Wrappers and plain versions
live in :mod:`repro_torch.kernels.map_fused.ops`.
"""
from repro_torch.kernels.map_fused.ops import (
    LAUNCHES,
    balance_scan,
    balance_scan_cost,
    balance_scan_plain,
    evict_stats,
    evict_stats_cost,
    evict_stats_plain,
    map_decide,
    map_decide_cost,
    map_decide_plain,
)

__all__ = ["LAUNCHES", "balance_scan", "balance_scan_cost",
           "balance_scan_plain", "evict_stats", "evict_stats_cost",
           "evict_stats_plain", "map_decide", "map_decide_cost",
           "map_decide_plain"]
