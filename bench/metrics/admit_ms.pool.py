"""Mean wall of ``SessionManager.admit`` in the window (ms): a masked
prefill at the pool's bucket and its row writes."""
from bench.harness import readers


def read(run):
    return readers.mean((a["end"] - a["start"]) * 1e3 for a in run.admits)
