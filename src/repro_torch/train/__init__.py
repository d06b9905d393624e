"""Serving steps of the port (counterpart of ``repro/train``; training is
not ported yet, ROADMAP A6b)."""
from repro_torch.train.steps import make_serve_steps

__all__ = ["make_serve_steps"]
