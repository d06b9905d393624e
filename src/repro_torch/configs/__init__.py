"""Model configurations of the port; counterpart of ``repro/configs``."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_configs,
    get_config,
    get_smoke_config,
)

__all__ = ["ARCH_IDS", "ModelConfig", "all_configs", "get_config",
           "get_smoke_config"]
