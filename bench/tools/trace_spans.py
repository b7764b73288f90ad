"""Traced runs of a cell, one JSON line a run: the run's own result line
(its per-layer metrics, the span metrics among them, and in its notes
``spans.notes``: idle by the deepest serving-thread span, set-up's spans,
the window's counters) and the clock check.

    python3 bench/tools/trace_spans.py --workload <cell> --seeds 7,8 \\
        [--seconds 51]

A ``--trace 1`` run of the harness records the program's spans and
counters (``run.spans``, ``run.counts``) and the traced stretch's device
records (``run.trace.records``); this tool reads them from the run.
"""
import argparse
import bisect
import gc
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def clock_excess_ms(run):
    """The most by which a device record that started before a serving
    thread's ``wait`` span began ends after the span ended (ms), over the
    waits that lie in the stretch and overlap no span of another thread;
    None without records or waits.  The work such a record belongs to was
    queued before the wait, so it ended before the wait did, unless the
    two clocks disagree.  (A record starting after the wait began may be
    the loop's next launch, which can start within the marker's
    placement of the device clock of the wait's end.)"""
    from bench.harness import spans as SP
    recs, t = run.trace.records, run.trace
    if not recs:
        return None
    starts = [s for s, _, _ in recs]                 # sorted by start
    last_end = list(itertools.accumulate((e for _, e, _ in recs), max))
    others = [s for s in run.spans if s["thread"] != SP.SERVING]
    worst = None
    for w in SP.inside(run.spans, SP.WAIT, t.host_t0, t.host_t1):
        if any(o["start"] < w["end"] and w["start"] < o["end"]
               for o in others):
            continue
        i = bisect.bisect_right(starts, w["start"])
        if i:
            x = (last_end[i - 1] - w["end"]) * 1e3
            worst = x if worst is None else max(worst, x)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    import torch
    from bench.harness.main import run_and_record
    if not torch.cuda.is_available():
        print("trace_spans: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out, run = run_and_record(args.workload, seed, args.seconds, True)
        print(json.dumps({"cell": args.workload, "seed": seed, "out": out,
                          "clock_excess_ms": clock_excess_ms(run)}),
              flush=True)
        del out, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
