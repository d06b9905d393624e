"""zamba2-2.7b [hybrid] — 54L d2560 32H (kv=32) ff=10240 vocab=32000,
ssm_state=64. Mamba2 backbone + one SHARED attention block invoked every 6
layers (9 invocations with per-invocation norms). [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32_000,
    ssm_state=64, attn_every=6,
)

SMOKE = CONFIG.scaled(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=256,
    attn_every=3, ssm_state=16, ssm_head_dim=32, ssm_chunk=16,
)
