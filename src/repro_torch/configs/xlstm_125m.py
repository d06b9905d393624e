"""xlstm-125m [ssm] — 12L d768 4H ff=0 vocab=50304.

sLSTM + mLSTM blocks. slstm_every=2: odd layers sLSTM, even layers mLSTM
(6+6 of the 12). d_ff=0 per the assignment: the xLSTM blocks carry their own
up/down projections instead of a separate MLP. [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304, slstm_every=2,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
)
