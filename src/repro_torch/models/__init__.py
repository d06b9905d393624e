"""Model substrate of the port: the dense and hybrid families' init,
forward, prefill and decode (counterpart of ``repro/models``)."""
from repro_torch.models import layers, ssm, transformer
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init,
    init_cache,
    param_shapes,
    param_spec,
    prefill,
)

__all__ = ["layers", "ssm", "transformer", "init", "forward", "prefill",
           "decode_step", "init_cache", "param_shapes", "param_spec"]
