"""Device resolution shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA device. A run
never falls back to the CPU silently: without a CUDA device the caller
must ask for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as given.

    Raises RuntimeError when ``cuda`` is asked for (explicitly or by
    default) and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" "
            "(or --device cpu) to run on the CPU"
        )
    return dev
