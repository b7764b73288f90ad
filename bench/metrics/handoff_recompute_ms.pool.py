"""Mean wall of the window's ``handoff.recompute`` spans (ms): the
masked re-prefill over ``(slots, max_seq)`` a recompute hand-off runs."""
from bench.harness import readers, spans


def read(run):
    return readers.mean((s["end"] - s["start"]) * 1e3
                        for s in spans.window_spans(run, "handoff.recompute"))
