"""whisper-medium [audio] — 24L d1024 16H (kv=16) ff=4096 vocab=51865.

Encoder-decoder backbone; conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (S_enc = seq_len // 2) and the decoder sees
seq_len // 2 positions, so a shape cell exercises ~seq_len total positions.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51_865, encoder_layers=24,
    mlp="gelu", norm="layernorm",
)

SMOKE = CONFIG.scaled(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
)
