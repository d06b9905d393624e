"""phi4-mini-3.8b [dense] — 32L d3072 24H (GQA kv=8) ff=8192 vocab=200064.

RoPE SwiGLU GQA. [arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200_064,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=256, vocab_size=512,
)
