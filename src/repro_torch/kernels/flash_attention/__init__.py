"""Blockwise attention kernel ``flash_attention``; wrapper and plain
version in :mod:`repro_torch.kernels.flash_attention.ops`."""
from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    flash_attention,
    flash_attention_cost,
    flash_attention_plain,
)

__all__ = ["LAUNCHES", "flash_attention",
           "flash_attention_cost", "flash_attention_plain"]
