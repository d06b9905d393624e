"""PyTorch/CUDA port of the FELARE scheduling simulator.

The package mirrors the JAX package ``repro`` module for module
(``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py``, and so on) and covers the flat, single-site
sweep: trace synthesis, the batched event loop, the eight composed
mapping policies and the sweep CLI. The three per-event map-decision
kernels (``kernels/map_fused`` and ``kernels/phase1_map``) are CUDA C++
written for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device they raise.
Nothing here imports JAX.
"""
from repro_torch.core.device import resolve_device

__all__ = ["resolve_device"]
