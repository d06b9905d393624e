"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) expert ff=512
vocab=49155, MoE 40 experts top-8.

The assignment string says "MoE 40e top-8" (the bracketed hf pointer is the
32-expert 1b sibling); the explicit config string wins — recorded in
DESIGN.md. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49_155,
    n_experts=40, experts_per_token=8,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=64, vocab_size=256,
    n_experts=8, experts_per_token=2,
)
