"""Architecture registry: arch id -> :class:`ModelConfig` (full + smoke).

The port holds the architectures whose serving path it runs. The
reference's other ids (moe, xlstm, audio and vlm families) wait for their
families (ROADMAP A1) and raise ``KeyError`` here.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP A1); the "
                       f"port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke_config(arch: str):
    return _mod(arch).SMOKE
