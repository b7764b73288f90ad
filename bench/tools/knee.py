"""The knee sweep of a ``requests`` cell: the same cell's window at each
of a list of arrival rates, in one process, without the check.  For each
rate it prints the request latencies' median, 95th percentile and
maximum and the requests still unfinished when the window closed; the
knee is the highest rate whose backlog does not grow through the window.

    python3 bench/tools/knee.py --workload <cell> --rates 6,7,8 --seconds 20
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch
    from bench.harness.main import run_cell
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        out = run_cell(args.workload, args.seed, args.seconds, False,
                       rate=rate, check=False)
        m = out["metrics"]
        print(json.dumps({"rate": rate, "attempted": out["attempted"],
                          "failed": out["failed"],
                          "req_p95_ms": m.get("req_p95_ms", {}).get("value"),
                          "late_at_close": out["notes"]["late_at_close"],
                          "notes": out["notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
