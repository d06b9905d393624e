"""Model substrate of the port: every family's init, forward, prefill and
decode (counterpart of ``repro/models``)."""
from repro_torch.models import layers, moe, ssm, transformer, xlstm
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init,
    init_cache,
    param_shapes,
    param_spec,
    prefill,
)

__all__ = ["layers", "moe", "ssm", "transformer", "xlstm", "init",
           "forward", "prefill", "decode_step", "init_cache", "param_shapes",
           "param_spec"]
