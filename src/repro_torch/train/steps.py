"""Train and serve steps on one device (counterpart of
``repro/train/steps.py`` without a mesh).

``make_train_step``: gradient accumulation over the batch's leading axis
(A microbatches), per-block remat inside the model, the AdamW update.
``make_grad_step`` is its first half: the float32 gradients averaged over
the microbatches, and the loss.

``make_serve_steps``: prefill plus single-token decode.

Training runs the plain attention and SSD paths (:data:`TRAIN_IMPLS`): the
hand-written kernels have no backward pass, as the JAX package's Pallas
kernels have none, and the reference trains on XLA's paths. A config that
names a kernel is refused, never switched quietly.
"""
from __future__ import annotations

import torch

from repro_torch import tree as tr
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.train.loss import make_loss_fn

#: The implementations training runs: ``cfg.scaled(**TRAIN_IMPLS)``.
TRAIN_IMPLS = {"attn_impl": "plain", "ssm_impl": "plain"}


def make_grad_step(cfg, device=None):
    """-> ``grad_step(params, batch) -> (grads, metrics)`` on ``device``
    (``None`` = CUDA; raises without one).

    batch: numpy arrays or tensors with a leading microbatch axis, tokens
    (A, mb, S); they are moved to the device. Per microbatch the
    gradients, taken to float32, are added to a float32 sum, which is
    divided by A: ``grads`` has the structure of ``params``, float32.
    ``metrics``: ``loss`` (the mean over microbatches) and ``tokens``
    (their sum), float32 scalars.
    """
    bad = [f"{k}={getattr(cfg, k)!r}" for k in TRAIN_IMPLS
           if getattr(cfg, k) == "kernel"]
    if bad:
        raise ValueError(
            f"{', '.join(bad)}: the kernels have no backward pass (nor have "
            f"the JAX package's Pallas kernels); train with "
            f"cfg.scaled(attn_impl=\"plain\", ssm_impl=\"plain\")")
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg)

    def grad_step(params, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        leaves = tr.leaves(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        tsum = torch.zeros((), dtype=torch.float32, device=dev)
        A = batch["tokens"].shape[0]
        for a in range(A):
            live = [p.detach().requires_grad_(True) for p in leaves]
            total, metrics = loss_fn(tr.unflatten_like(params, live),
                                     {k: v[a] for k, v in batch.items()})
            for acc, g in zip(gsum, torch.autograd.grad(total, live)):
                acc.add_(g)
            lsum = lsum + metrics["loss"].detach()
            tsum = tsum + metrics["tokens"]
        for acc in gsum:
            acc.div_(A)
        return (tr.unflatten_like(params, gsum),
                {"loss": lsum / A, "tokens": tsum})

    return grad_step


def make_train_step(cfg, optimizer, mesh=None, *, lr_schedule=None,
                    donate: bool = True, device=None):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (``None`` = CUDA; raises without one).

    batch["tokens"]: (A, mb, S), A grad-accumulation microbatches (see
    :func:`make_grad_step`). ``lr_schedule(opt_state.step)`` gives the
    rate when set. ``donate=True`` updates ``params`` and ``opt_state``
    in place (the counterpart of buffer donation); ``donate=False`` leaves
    them untouched. metrics: ``loss``, ``grad_norm`` (before clipping)
    and ``tokens``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): the sharded step is not ported yet "
            "(ROADMAP A6b, distributed/); the port trains on one device")
    grad_step = make_grad_step(cfg, device)

    def train_step(params, opt_state, batch):
        grads, m = grad_step(params, batch)
        lr = lr_schedule(opt_state.step) if lr_schedule else None
        params, opt_state, gnorm = optimizer.update(
            grads, opt_state, params, lr=lr, inplace=donate)
        return params, opt_state, {"loss": m["loss"], "grad_norm": gnorm,
                                   "tokens": m["tokens"]}

    return train_step


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
