"""Architecture registry: arch id -> :class:`ModelConfig` (full + smoke).

Counterpart of ``repro/configs/registry.py``: all ten ids, in the
reference's order. Every config resolves, and the port builds, prefills
and decodes every one of them (all six families).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "command-r-35b": "command_r_35b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "xlstm-125m": "xlstm_125m",
    "whisper-medium": "whisper_medium",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke_config(arch: str):
    return _mod(arch).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
