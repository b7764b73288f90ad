"""Bytes the window's evictions copied to the host (``d2h_bytes`` of the
``park.copy`` spans) over those spans' summed wall (GB/s)."""
from bench.harness import spans


def read(run):
    copies = spans.window_spans(run, "park.copy")
    wall = sum(s["end"] - s["start"] for s in copies)
    if not wall:
        return None
    return sum(s["attrs"].get("d2h_bytes", 0) for s in copies) / wall / 1e9
