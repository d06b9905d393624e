"""ELARE Phase-I kernel ``phase1_map``; wrapper and plain version in
:mod:`repro_torch.kernels.phase1_map.ops`."""
from repro_torch.kernels.phase1_map.ops import (
    LAUNCHES,
    phase1_map,
    phase1_map_cost,
    phase1_map_plain,
)

__all__ = ["LAUNCHES", "phase1_map", "phase1_map_cost", "phase1_map_plain"]
