"""qwen1.5-0.5b [dense] — 24L d1024 16H (kv=16 MHA) ff=2816 vocab=151936.

QKV bias path exercised. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151_936, qkv_bias=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=384,
)
