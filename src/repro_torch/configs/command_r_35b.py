"""command-r-35b [dense] — 40L d8192 64H (GQA kv=8) ff=22528 vocab=256000.

GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256_000, qkv_bias=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=352,
    vocab_size=512,
)
