"""CLI entry for the port's serving package:
``python -m repro_torch.serving --smoke [--device cpu]``.

Lives here (not in engine.py's ``__main__`` guard) so the smoke runs the
canonical ``repro_torch.serving.engine`` module instead of runpy
re-executing it as a second copy of every class.  The device defaults to
the card.  Importing this module runs nothing.
"""
import argparse

from repro_torch.serving.engine import _smoke


def main() -> int:
    ap = argparse.ArgumentParser(
        description="ServingEngine measured-stream smoke")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny deterministic run asserting the measured "
                         "downtime ordering")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    if not args.smoke:
        ap.error("only --smoke is supported as a direct invocation")
    return _smoke(device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
