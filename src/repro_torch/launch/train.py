"""Training launcher.

On the card, at a model's published size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 20 --batch 1 --seq 2048 --lr 3e-4

On the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 200 --batch 8 --seq 64

The counterpart of ``repro/launch/train.py`` with ``--device`` (the card
by default).  On the CPU it refuses a model over 1e9 parameters, as the
reference refuses one on a laptop.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.training import train


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant (required on CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    elif dev.type == "cpu" and cfg.param_count() > 1e9:
        raise SystemExit(
            f"{args.arch} has {cfg.param_count()/1e9:.1f}B params; use "
            "--reduced on CPU (a laptop) or --device cuda")
    hist = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, checkpoint_path=args.checkpoint or None,
                 checkpoint_every=args.checkpoint_every, device=dev)
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(first {hist['loss'][0]:.4f}) over {args.steps} steps")


if __name__ == "__main__":
    main()
