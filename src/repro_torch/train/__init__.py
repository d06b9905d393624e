"""Training and serving of the port (counterpart of ``repro/train``): the
chunked LM loss, the train step (one device or a mesh), the
fault-tolerant loop, and the serve steps."""
from repro_torch.train.loss import chunked_lm_loss, make_loss_fn
from repro_torch.train.steps import (
    TRAIN_IMPLS,
    make_grad_step,
    make_serve_steps,
    make_train_step,
)

__all__ = ["TRAIN_IMPLS", "chunked_lm_loss", "make_grad_step",
           "make_loss_fn", "make_serve_steps", "make_train_step"]
