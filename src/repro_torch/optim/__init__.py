"""Optimizer and learning-rate schedules of the port (counterpart of
``repro/optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.schedule import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamWState", "constant", "cosine_with_warmup"]
