"""A traced run of a cell with the program's span recorder on
(``repro_torch.core.timing.tracing``), read by the span metrics and
``bench/harness/spans.py``: the run's own result line, then the span
metrics, the span notes and the clock check, one JSON line a run.

    python3 bench/tools/trace_spans.py --workload <cell> --seeds 7,8 \\
        [--seconds 51] [--recorder 0|1]

The harness records no program spans yet (PERF.md, Open questions), so
this tool lends its ``Context`` the two lines that would: the counters
taken at the window's start and end, the spans shifted by the window's
start onto the run's clock, and the stretch's device records kept.
``--recorder 0`` makes the same traced run with the recorder off (its
cost is the difference of the two runs' host-clock metrics).
"""
import argparse
import bisect
import gc
import itertools
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SPAN_METRICS = {
    "pool": ("step_host_ms.pool", "launches_per_step.pool",
             "syncs_per_step.pool", "park_gbps.pool",
             "handoff_recompute_ms.pool", "idle_host_pct.pool"),
    "stream": ("idle_host_pct.stream",),
}


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
    recs, t = getattr(run.trace, "records", None), run.trace
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


def run_with_spans(cell: str, seed: int, seconds: float, *,
                   recorder: bool = True, device="cuda", spec=None):
    """One traced run of ``cell`` (``spec``: its ``Cell``, for a reduced
    one); returns ``(result line, run)``, the run carrying ``spans``,
    ``counts`` and ``trace.records``."""
    import torch
    from bench.harness import main as M
    from bench.harness import spans as SP
    from bench.harness import trace as TR
    from repro_torch.core import timing

    ctxs = []

    class SpanContext(M.Context):
        def start_window(self):
            clock = super().start_window()
            timing.take_counts()            # set-up's
            ctxs.append(self)
            return clock

        def end_window(self):
            super().end_window()
            self.run.counts = timing.take_counts()

    plain = TR.summarize

    def summarize(events, t0, t1, marker_t, require=True):
        events = list(events)
        s = plain(events, t0, t1, marker_t, require)
        s.records = SP.device_records(events, t0, t1, marker_t)
        return s

    timing.take_spans()
    timing.take_counts()
    timing.tracing(recorder)
    try:
        with mock.patch.object(M, "Context", SpanContext), \
                mock.patch.object(TR, "summarize", summarize):
            out = M.run_cell(cell, seed, seconds, True, device=device,
                             cell=spec)
    finally:
        timing.tracing(False)
    ctx = ctxs.pop()            # the context holds the weights: let go
    run = ctx.run
    run.spans = SP.on_run_clock(timing.take_spans(), ctx._t0)
    del ctx
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out, run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    import torch
    from bench.harness import spans as SP
    from bench.harness import spec as S
    if not torch.cuda.is_available():
        print("trace_spans: no CUDA device", file=sys.stderr)
        return 2
    kind = "pool" if args.workload.endswith(".pool") else "stream"
    for seed in (int(s) for s in args.seeds.split(",")):
        out, run = run_with_spans(args.workload, seed, args.seconds,
                                  recorder=bool(args.recorder))
        metrics = {m: S.metric_reader(m)(run) for m in SPAN_METRICS[kind]}
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "recorder": args.recorder, "out": out,
                          "span_metrics": metrics,
                          "span_notes": SP.notes(run),
                          "clock_excess_ms": clock_excess_ms(run)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
