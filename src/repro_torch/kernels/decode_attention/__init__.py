"""Single-token decode attention kernel ``decode_attention``; wrapper and
plain version in :mod:`repro_torch.kernels.decode_attention.ops`."""
from repro_torch.kernels.decode_attention.ops import (
    LAUNCHES,
    decode_attention,
    decode_attention_cost,
    decode_attention_plain,
)

__all__ = ["LAUNCHES", "decode_attention", "decode_attention_cost",
           "decode_attention_plain"]
