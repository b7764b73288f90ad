"""``syncs`` (the program's explicit waits) plus ``implicit_syncs``
(``.item()``, ``.cpu()`` and the like) counted inside the traced
stretch's ``step`` spans, over those steps."""
from bench.harness import spans


def read(run):
    return spans.counted_per(run, "step")
