"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's weights and traffic
from the seed, sets the program up, measures for ``--seconds`` seconds,
checks what the timed path produced against the plain reference, and
prints the result as one JSON line, last on standard output, with the
numbers compared and their limits last on standard error.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a traced stretch of the window.

It exits with another code than 0, and prints no result, when the card
or the chips the cell asks for are missing, or when ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package) is loaded once the window has
closed.  ``--control 1`` judges the check's control (the reference in
fp8) in the program's place, which has to come out not correct;
``--rate`` overrides a ``requests`` mix's arrival rate for the knee
sweep.  Neither is part of a benchmark run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at
# fixed paths (the kernels' own library goes to build/kernels/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)

    import torch
    from bench.harness import spec as S
    from bench.harness.main import forbidden_modules, run_cell

    cell = S.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START,
                   control=bool(args.control), rate=args.rate, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, lim in out["limits"].items():
        print(f"{name} {lim['value']} limit {lim['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
