"""Serve steps: prefill plus single-token decode.

Counterpart of ``make_serve_steps`` in ``repro/train/steps.py`` without
the mesh: one device, no sharding. ``make_train_step`` waits for the
training slice (ROADMAP A6b).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf


def make_serve_steps(cfg, device=None):
    """-> ``(prefill_step(params, batch, *, max_seq), decode_step(params,
    cache, tokens))`` on ``device`` (``None`` = CUDA; raises without one).

    ``prefill_step`` returns float32 logits (B, 1, V) for the prompt's
    last position and the cache; ``decode_step`` returns the next logits
    and the cache, updated in place. Token tensors are moved to the
    device; the parameters must already be there.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch, *, max_seq: int):
        batch = {k: v.to(dev) for k, v in batch.items()}
        hidden, cache = tf.prefill(cfg, params, batch, max_seq)
        return ll.unembed_apply(cfg, params["embed"], hidden), cache

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        return tf.decode_step(cfg, params, cache, tokens.to(dev))

    return prefill_step, decode_step
