"""Train and serve steps, on one device or sharded over a mesh
(counterpart of ``repro/train/steps.py``).

``make_train_step``: gradient accumulation over the batch's leading axis
(A microbatches), per-block remat inside the model, the AdamW update.
``make_grad_step`` is its first half: the float32 gradients averaged over
the microbatches, and the loss.

``make_serve_steps``: prefill plus single-token decode.

Given a ``DeviceMesh`` both keep the reference's contract: parameters,
optimizer state, batches and caches go in and out as ``DTensor`` s in
``distributed.sharding``'s layouts. The compute gathers (FSDP-style):
each rank gathers the whole parameters, runs its rows of the batch
through the one-device functions above (the kernel wrappers get its
local tensors, never a DTensor), and the float32 gradients are summed
over the data-parallel ranks, each rank's share of every microbatch's
loss weighted by its share of the microbatch's tokens, and cut back
into the parameter layout, where AdamW updates the local shards. MoE
layers route the whole batch's tokens on every rank (their groups,
capacities and load-balancing loss are the whole batch's, as in the
reference). Ranks on the ``model`` axis compute the same rows (no
tensor-parallel compute).

Training runs the plain attention and SSD paths (:data:`TRAIN_IMPLS`): the
hand-written kernels have no backward pass, as the JAX package's Pallas
kernels have none, and the reference trains on XLA's paths. A config that
names a kernel is refused, never switched quietly.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch import tree as tr
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers as ll
from repro_torch.models import moe
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
    _check_train_impls(cfg)
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg)

    def grad_step(params, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        gsum, ms = _accumulate(loss_fn, params, batch,
                               lambda total, _: total)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        tsum = torch.zeros((), dtype=torch.float32, device=dev)
        for m in ms:
            lsum = lsum + m["loss"]
            tsum = tsum + m["tokens"]
        A = len(ms)
        for acc in gsum:
            acc.div_(A)
        return (tr.unflatten_like(params, gsum),
                {"loss": lsum / A, "tokens": tsum})

    return grad_step


def _check_train_impls(cfg) -> None:
    bad = [f"{k}={getattr(cfg, k)!r}" for k in TRAIN_IMPLS
           if getattr(cfg, k) == "kernel"]
    if bad:
        raise ValueError(
            f"{', '.join(bad)}: the kernels have no backward pass (nor have "
            f"the JAX package's Pallas kernels); train with "
            f"cfg.scaled(attn_impl=\"plain\", ssm_impl=\"plain\")")


def _accumulate(loss_fn, params, batch, objective):
    """The float32 gradients of ``objective(total, metrics)`` (one scalar
    per microbatch of ``batch``, from ``loss_fn``'s results) summed over
    the microbatches, in ``tr.leaves`` order, and each microbatch's
    metrics, detached."""
    leaves = tr.leaves(params)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    ms = []
    for a in range(batch["tokens"].shape[0]):
        live = [p.detach().requires_grad_(True) for p in leaves]
        total, metrics = loss_fn(tr.unflatten_like(params, live),
                                 {k: v[a] for k, v in batch.items()})
        for acc, g in zip(gsum, torch.autograd.grad(
                objective(total, metrics), live)):
            acc.add_(g)
        ms.append({k: v.detach() for k, v in metrics.items()})
    return gsum, ms


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

    With a ``DeviceMesh`` (every rank calls the step; the device is the
    mesh's): params and opt_state are ``DTensor`` s in the layouts
    ``train_step.param_shardings`` / ``train_step.opt_shardings``, the
    batch (the whole numpy arrays on every rank, or DTensors) is split on
    its microbatch rows over the data-parallel axes, and the metrics are
    plain scalars, the same on every rank. ``train_step.jit_for(batch
    shapes)`` returns the step (the reference's call sites read the
    same; nothing is compiled), and ``train_step.sharded_grads(params,
    batch)`` its gradients in the parameter layout and its metrics.
    """
    if mesh is not None:
        return _make_sharded_train_step(cfg, optimizer, mesh,
                                        lr_schedule=lr_schedule,
                                        donate=donate)
    grad_step = make_grad_step(cfg, device)

    def train_step(params, opt_state, batch):
        grads, m = grad_step(params, batch)
        lr = lr_schedule(opt_state.step) if lr_schedule else None
        params, opt_state, gnorm = optimizer.update(
            grads, opt_state, params, lr=lr, inplace=donate)
        return params, opt_state, {"loss": m["loss"], "grad_norm": gnorm,
                                   "tokens": m["tokens"]}

    return train_step


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(repro_torch.launch.mesh.make_mesh), not "
                        f"{type(mesh).__name__}")


def _make_sharded_train_step(cfg, optimizer, mesh, *, lr_schedule, donate):
    _check_mesh(mesh)
    pshapes = tf.param_shapes(cfg)
    pshard = sh.param_shardings(pshapes, mesh, cfg)
    oshard = sh.opt_state_shardings(pshapes, mesh, cfg)
    grad_step = make_grad_step(cfg, sh.mesh_device(mesh))
    shared_step = _make_shared_grad_step(cfg, mesh)

    def sharded_grads(params, batch):
        layouts = sh.batch_sharding(mesh, batch, accum_dim=True)
        local = sh.map_path(lambda _, x, lay: sh.to_rows(x, lay), batch,
                            layouts)
        rows_split = layouts["tokens"].spec[1] is not None
        step = shared_step if rows_split else grad_step
        grads, m = step(sh.gather(params), local)
        return sh.distribute(grads, pshard), m

    def train_step(params, opt_state, batch):
        grads, m = sharded_grads(params, batch)
        lr = (lr_schedule(sh.to_local(opt_state.step)) if lr_schedule
              else None)
        params, opt_state, gnorm = optimizer.update(
            grads, opt_state, params, lr=lr, inplace=donate)
        return params, opt_state, {"loss": m["loss"], "grad_norm": gnorm,
                                   "tokens": m["tokens"]}

    train_step.jit_for = lambda batch_shapes: train_step
    train_step.param_shardings = pshard
    train_step.opt_shardings = oshard
    train_step.sharded_grads = sharded_grads
    return train_step


def _make_shared_grad_step(cfg, mesh):
    """``make_grad_step``'s counterpart for a batch whose microbatch rows
    are split over the data-parallel ranks (each rank passes its rows):
    the gradients and metrics of the whole batch, the same on every rank.

    Each rank differentiates its share of every microbatch's loss: its LM
    loss weighted by its share of the microbatch's tokens (counted over
    the ranks), plus the MoE's load-balancing loss over the ranks' count.
    That loss is the whole microbatch's (the experts route the whole
    microbatch's tokens, ``models.moe.rows_shared``), so the shares sum
    over the ranks to the whole microbatch's loss, and the gradients,
    summed over the ranks and averaged over the microbatches, are the
    whole batch's."""
    _check_train_impls(cfg)
    loss_fn = make_loss_fn(cfg)
    dp, n_dp = sh.batch_axes(mesh), sh.dp_size(mesh)

    def grad_step(params, batch):
        shares = []

        def objective(_, m):
            n = sh.all_reduce_mesh(m["tokens"].detach().clone(), mesh, dp)
            w = m["tokens"] / torch.clamp(n, min=1.0)
            shares.append(m["loss"].detach() * w)
            return m["loss"] * w + loss_fn.aux_weight * m["aux"] / n_dp

        with moe.rows_shared(*sh.shared_rows(mesh)):
            gsum, ms = _accumulate(loss_fn, params, batch, objective)
        A = len(ms)
        sums = torch.stack([sum(shares), sum(m["tokens"] for m in ms)])
        loss, tokens = sh.all_reduce_mesh(sums, mesh, dp)
        for acc in gsum:
            sh.all_reduce_mesh(acc, mesh, dp).div_(A)
        return (tr.unflatten_like(params, gsum),
                {"loss": loss / A, "tokens": tokens})

    return grad_step


def make_serve_steps(cfg, mesh=None, device=None):
    """-> ``(prefill_step(params, batch, *, max_seq), decode_step(params,
    cache, tokens))`` on ``device`` (``None`` = CUDA; raises without one).

    ``prefill_step`` returns float32 logits (B, 1, V) for the prompt's
    last position and the cache; ``decode_step`` returns the next logits
    and the cache, updated in place. Token tensors are moved to the
    device; the parameters must already be there.

    With a ``DeviceMesh``: -> ``(prefill_jit_for(batch_shapes, max_seq),
    decode_jit_for(cache_shapes, token_shapes))``, the reference's meshed
    form; each returns a step whose parameters, caches and tokens go in
    and out as ``DTensor`` s in ``param_shardings`` / ``cache_sharding``
    / ``batch_sharding``'s layouts (whole tensors or arrays are taken as
    well). Each rank gathers the parameters and runs its batch rows, with
    every head, through the steps above; the decode step updates the
    cache's local shards in place.
    """
    if mesh is not None:
        return _make_sharded_serve_steps(cfg, mesh)
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


def _make_sharded_serve_steps(cfg, mesh):
    _check_mesh(mesh)
    prefill_step, decode_step = make_serve_steps(
        cfg, device=sh.mesh_device(mesh))

    def logits_layout(batch: int):
        return sh.batch_sharding(mesh, torch.empty(
            (batch, 1, cfg.vocab_size), device="meta"))

    def rows_layouts(cshard, batch_entry):
        """Each cache leaf's rows on this rank, other dims whole; ``len``
        and ``xlen`` (replicated) split like the tokens' rows."""
        return sh.map_path(
            lambda path, lay: sh.Layout(mesh, (batch_entry,))
            if path[-1] in ("len", "xlen") else lay.rows(), cshard)

    def routed(rows_entry):
        """Split rows: the MoE layers route the whole batch's tokens."""
        if rows_entry is None:
            return contextlib.nullcontext()
        return moe.rows_shared(*sh.shared_rows(mesh))

    def prefill_jit_for(batch_shapes, max_seq: int):
        bshard = sh.batch_sharding(mesh, batch_shapes)
        B = batch_shapes["tokens"].shape[0]
        cshard = sh.cache_sharding(cfg, mesh, tf.init_cache(
            cfg, B, max_seq, device="meta"))
        crows = rows_layouts(cshard, bshard["tokens"].spec[0])
        oshard = logits_layout(B)

        @torch.no_grad()
        def prefill(params, batch):
            local = sh.map_path(lambda _, x, lay: sh.to_rows(x, lay),
                                batch, bshard)
            with routed(bshard["tokens"].spec[0]):
                logits, cache = prefill_step(sh.gather(params), local,
                                             max_seq=max_seq)
            return (sh.from_rows(logits, oshard),
                    sh.map_path(lambda _, x, lay, rows:
                                sh.from_rows(x, lay, rows),
                                cache, cshard, crows))
        return prefill

    def decode_jit_for(cache_shapes, token_shapes):
        cshard = sh.cache_sharding(cfg, mesh, cache_shapes)
        tshard = sh.batch_sharding(mesh, token_shapes)
        crows = rows_layouts(cshard, tshard.spec[0])
        oshard = logits_layout(token_shapes.shape[0])

        @torch.no_grad()
        def decode(params, cache, tokens):
            rows = sh.map_path(lambda _, x, lay: sh.to_rows(x, lay), cache,
                               crows)
            with routed(tshard.spec[0]):
                logits, new = decode_step(sh.gather(params), rows,
                                          sh.to_rows(tokens, tshard))

            def back(path, x, old_rows, new_rows, lay, lay_rows):
                if new_rows is old_rows and sh.holds_rows(x, lay_rows):
                    return x        # updated in place in its own storage
                out = sh.from_rows(new_rows, lay, lay_rows)
                if isinstance(x, DTensor) and path[-1] not in (
                        "len", "xlen"):
                    x.to_local().copy_(out.to_local())   # in place
                    return x
                return out
            return (sh.from_rows(logits, oshard),
                    sh.map_path(back, cache, rows, new, cshard, crows))
        return decode

    return prefill_jit_for, decode_jit_for
