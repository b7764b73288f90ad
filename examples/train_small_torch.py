"""Train a small model for a few hundred steps on the synthetic stream and
checkpoint it, on the PyTorch/CUDA port: exercises the data pipeline,
AdamW, remat and checkpointing.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_small_torch.py --device cpu

The steps of ``examples/train_small.py`` on ``repro_torch``'s modules, on
the card unless ``--device`` says otherwise; the checkpoint goes to
``experiments/train_small_torch.npz``.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.training import train

CHECKPOINT = "experiments/train_small_torch.npz"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    cfg = get_config(args.arch).reduced()
    hist = train(cfg, steps=args.steps, batch=8, seq=64, lr=3e-3,
                 checkpoint_path=CHECKPOINT, checkpoint_every=100,
                 log_every=20, device=args.device)
    assert hist["loss"][-1] < hist["loss"][0] - 0.5, "did not learn"
    print(f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
          f"({args.steps} steps, ckpt at {CHECKPOINT})")


if __name__ == "__main__":
    main()
