"""Assigned input shapes and per-architecture applicability.

Counterpart of ``repro/configs/shapes.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Families with sub-quadratic sequence handling (O(1)/O(w) decode state) run
# long_500k; pure full-attention archs skip it.
SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}


def applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "SKIP(full-attention): 512k dense KV cache infeasible"
    return True, ""


def cells(cfg):
    """All 4 assigned shape cells for an arch, with skip annotations."""
    out = []
    for name in SHAPES:
        ok, reason = applicable(cfg, name)
        out.append((name, ok, reason))
    return out
