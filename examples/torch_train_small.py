"""End-to-end training run of the PyTorch port (the port's copy of
examples/train_small.py): train a small LM for a few hundred steps with
periodic async checkpoints, then resume from the checkpoint to prove
restart continuity.

Default is a CPU-sized model so the example finishes in minutes; pass
--preset 100m for the ~100M-parameter configuration on the card. The
model trains on its plain attention path (the kernels have no backward
pass).

Run: PYTHONPATH=src python examples/torch_train_small.py [--steps 200] \
         [--device cpu]
Without ``--device`` it runs on the CUDA card (and wants one).
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import registry
from repro_torch.core.device import resolve_device
from repro_torch.train import TRAIN_IMPLS
from repro_torch.train.loop import TrainJob, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}")
        return 2

    base = registry.get_smoke_config(args.arch).scaled(**TRAIN_IMPLS)
    if args.preset == "100m":
        cfg = base.scaled(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                          d_ff=2048, vocab_size=32_000)
        batch, seq = 32, 512
    else:
        cfg = base.scaled(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=352, vocab_size=2048)
        batch, seq = 8, 64

    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    job = TrainJob(cfg=cfg, steps=args.steps, batch=batch, seq=seq,
                   accum=2, lr=3e-3, ckpt_dir=ckpt_dir, ckpt_every=50,
                   device=device)

    print(f"training {args.arch} ({args.preset}) for {args.steps} steps on "
          f"{device}; checkpoints -> {ckpt_dir}")

    def log(step, rec):
        if step % 20 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f}")

    _, _, hist = run(job, on_step=log)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")

    # resume from the final checkpoint for 10 extra steps (restart proof)
    job2 = TrainJob(cfg=cfg, steps=args.steps + 10, batch=batch, seq=seq,
                    accum=2, lr=3e-3, ckpt_dir=ckpt_dir, ckpt_every=50,
                    device=device)
    _, _, hist2 = run(job2, on_step=None)
    print(f"resumed from step {hist2[0]['step']} "
          f"(loss {hist2[0]['loss']:.4f}) to step {hist2[-1]['step']}")
    if args.ckpt is None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
