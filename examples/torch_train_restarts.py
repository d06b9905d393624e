"""Fault-tolerance demo of the PyTorch port (the port's copy of
examples/train_restarts.py): inject two preemptions mid-training and
watch the supervisor restart from the last checkpoint with no loss-curve
damage.

Run: PYTHONPATH=src python examples/torch_train_restarts.py [--device cpu]
Without ``--device`` it runs on the CUDA card (and wants one).
"""
import argparse
import tempfile

from repro_torch.configs import registry
from repro_torch.core.device import resolve_device
from repro_torch.train import TRAIN_IMPLS
from repro_torch.train.loop import SimulatedFailure, TrainJob, run_with_restarts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}")
        return 2
    cfg = registry.get_smoke_config("internlm2-1.8b").scaled(
        n_layers=2, d_model=64, vocab_size=512, **TRAIN_IMPLS)
    with tempfile.TemporaryDirectory() as d:
        job = TrainJob(cfg=cfg, steps=60, batch=4, seq=32, ckpt_dir=d,
                       ckpt_every=10, lr=3e-3, device=device)
        failures = {
            17: SimulatedFailure("node 3 preempted"),
            41: SimulatedFailure("pod-2 power event"),
        }
        _, _, hist, restarts = run_with_restarts(job, failures=failures)
        print(f"finished 60 steps with {restarts} restarts on {device}")
        print(f"final loss {hist[-1]['loss']:.4f} at step {hist[-1]['step']}")
        redone = [h["step"] for h in hist]
        print(f"steps re-executed after restarts: "
              f"{len(redone) - len(set(redone))} (work lost, bounded by "
              f"ckpt_every=10)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
