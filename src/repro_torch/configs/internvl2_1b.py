"""internvl2-1b [vlm] — 24L d896 14H (GQA kv=2) ff=4864 vocab=151655.

InternViT frontend is a STUB: input_specs() provides 256 precomputed patch
embeddings prepended to the text tokens; backbone is the Qwen2-0.5B-class LM.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151_655, qkv_bias=True, n_patches=256,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128, vocab_size=256,
    n_patches=16,
)
