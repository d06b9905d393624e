"""Training launcher: ``--arch <id>`` on one device or on a mesh of
ranks, with checkpoints and restart (counterpart of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 50 --smoke --device cpu      # reduced config, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20                           # the full config, on the card
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch internlm2-1.8b --model-axis 2 # (4, 2) host mesh, 8 cards
  ... --production-mesh                    # (16, 16): 256 ranks

The model trains on its plain attention and SSD paths (the kernels have
no backward pass; the reference trains on XLA's), and the first line
says so. Weights are the port's own draw (``torch.Generator`` seed 0),
batches ``SyntheticLM``'s. ``tok/s`` counts the tokens of the steps since
the previous line.

Under ``torchrun`` (or in a process group already joined) the ranks form
``make_host_mesh(--model-axis)`` over (data, model), or the production
mesh, and train through the sharded step; rank 0 prints. A mesh of one
rank takes the unsharded step, as the reference does on one device. A
group the mesh cannot hold gives an ``error:`` line and exit 2.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core.device import resolve_device
from repro_torch.datapipe.synthetic import Prefetcher, SyntheticLM
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train.steps import TRAIN_IMPLS, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) production mesh (256 ranks)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="TP width of the host mesh")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _mesh(args, dev):
    """The run's mesh over its process group (``torchrun``'s, or one
    already joined), or ``None`` for one rank (the unsharded step)."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        dev = mesh_mod.init_distributed(dev)
        mesh = (mesh_mod.make_production_mesh(device=dev)
                if args.production_mesh
                else mesh_mod.make_host_mesh(args.model_axis, device=dev))
        return None if mesh.size() == 1 else mesh
    if args.production_mesh or args.model_axis > 1:
        flag = ("--production-mesh" if args.production_mesh
                else f"--model-axis {args.model_axis}")
        raise ValueError(f"{flag} needs a torch.distributed group of more "
                         f"than one rank; this run has 1 (start it under "
                         f"torchrun --nproc-per-node N)")
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    joined = dist.is_initialized()
    try:
        try:
            dev = resolve_device(args.device)
            mesh = _mesh(args, dev)
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}")
            return 2
        return _train(args, dev, mesh)
    finally:
        if dist.is_initialized() and not joined:    # the group it joined
            dist.destroy_process_group()


def _train(args, dev, mesh) -> int:
    if mesh is not None:
        dev = sh.mesh_device(mesh)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch)).scaled(**TRAIN_IMPLS)
    say(f"device={dev} attn_impl={cfg.attn_impl} ssm_impl={cfg.ssm_impl} "
        f"(the kernels have no backward pass)")

    opt = AdamW(lr=None)
    sched = cosine_with_warmup(args.lr, warmup=min(100, args.steps // 10 + 1),
                               total=args.steps)
    step_fn = make_train_step(cfg, opt, mesh, lr_schedule=sched,
                              donate=False, device=dev)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, accum=args.accum)

    start = 0
    if args.ckpt and ckpt.latest_step(args.ckpt) is not None:
        target = tf.param_shapes(cfg)
        shardings = None if mesh is None else {
            "p": step_fn.param_shardings, "o": step_fn.opt_shardings}
        state, start = ckpt.restore(
            args.ckpt, {"p": target, "o": opt.init(target)}, device=dev,
            shardings=shardings)
        params, opt_state = state["p"], state["o"]
        say(f"restored from step {start}")
    else:
        params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
        if mesh is not None:
            params = sh.distribute(params, step_fn.param_shardings)
        opt_state = opt.init(params)
    if mesh is not None:
        step_fn = step_fn.jit_for(data.batch_at(0))

    n_params = sum(p.numel() for p in tr.leaves(params))
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"devices={1 if mesh is None else mesh.size()} "
        f"batch={args.batch} seq={args.seq}")

    it = iter(Prefetcher(data.batch_at(s)
                         for s in range(start, args.steps)))
    t0, since = time.time(), 0
    pending = None
    for step in range(start, args.steps):
        batch = next(it)
        params, opt_state, m = step_fn(params, opt_state, batch)
        since += 1
        if step % 10 == 0 or step == args.steps - 1:
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            tput = since * args.batch * args.seq / max(time.time() - t0,
                                                       1e-9)
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {gnorm:.2f} tok/s {tput:.0f}")
            t0, since = time.time(), 0
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(args.ckpt, step + 1,
                                {"p": params, "o": opt_state},
                                blocking=False)
    if pending is not None:
        pending.join()
    if args.ckpt:
        ckpt.save(args.ckpt, args.steps, {"p": params, "o": opt_state})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
