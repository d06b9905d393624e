"""Chunked cross-entropy LM loss (counterpart of ``repro/train/loss.py``).

The LM head's product and the softmax run one sequence chunk at a time,
and each chunk sits under ``torch.utils.checkpoint``: its (B, C, V)
float32 logits are recomputed in the backward pass instead of being held
for every chunk (qwen1.5-0.5b's vocabulary is 151,936).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf


def _chunk_nll(cfg, embed, hc, yc, mc):
    """The masked negative log-likelihood summed over one chunk."""
    logits = ll.unembed_apply(cfg, embed, hc)              # f32 (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum()


def chunked_lm_loss(cfg, params, hidden, labels, mask, chunk: int = 512):
    """hidden: (B, S, d); labels, mask: (B, S). Returns (mean_loss,
    n_tokens), both float32 scalars.

    The chunk is the largest divisor of S not above ``chunk``; ``mask``
    zeroes padding and modality positions (a VLM's patch slots).
    """
    B, S, _ = hidden.shape
    C = min(chunk, S)
    while S % C:
        C -= 1
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, C):
        sl = slice(c0, c0 + C)
        args = (cfg, params["embed"], hidden[:, sl], labels[:, sl],
                mask[:, sl])
        if torch.is_grad_enabled():
            nll = checkpoint(_chunk_nll, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            nll = _chunk_nll(*args)
        loss_sum = loss_sum + nll
        count = count + mask[:, sl].sum()
    return loss_sum / torch.clamp(count, min=1.0), count


def make_loss_fn(cfg, aux_weight: float = 0.01):
    """-> ``loss_fn(params, batch) -> (scalar loss, metrics dict)``.

    batch: tokens (B, S) plus the family's extras, on the parameters'
    device; the labels are the tokens shifted left, the last position
    masked. A VLM's loss covers its text positions only (the hidden states
    cover patches + text). The loss to differentiate adds ``aux_weight``
    times the MoE's load-balancing loss; the metrics hold the LM loss,
    the aux loss and the token count.
    """
    def loss_fn(params, batch):
        hidden, aux = tf.forward(cfg, params, batch)
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
        if "mask" in batch:
            mask = mask * batch["mask"]
        if cfg.family == "vlm":
            hidden = hidden[:, cfg.n_patches:]
        loss, count = chunked_lm_loss(cfg, params, hidden, labels, mask)
        total = loss + aux_weight * aux
        return total, {"loss": loss, "aux": aux, "tokens": count}

    loss_fn.aux_weight = aux_weight
    return loss_fn
