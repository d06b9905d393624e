"""PyTorch/CUDA port of the FELARE scheduling simulator.

The package mirrors the JAX package ``repro`` module for module
(``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py``, and so on) and covers the sweep over flat and
federated systems (trace synthesis, the batched event loop, the eight
composed mapping policies, the dispatchers and the sweep CLI) and the
model substrate's serving path for all six families and its
single-device training (``configs``, ``models``, ``optim``, ``train``,
``checkpoint``, ``launch.train``). Every
kernel of the reference (``kernels/map_fused``, ``kernels/phase1_map``,
``kernels/flash_attention``, ``kernels/decode_attention``,
``kernels/ssm_scan``) is CUDA C++ written for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device they raise.
Nothing here imports JAX. Importing the package itself imports nothing
else: ``resolve_device`` (which needs torch) loads on first use, so the
AST layer of :mod:`repro_torch.analysis` runs without torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from repro_torch.core.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
