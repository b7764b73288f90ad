"""Mean wall of ``SessionManager.evict`` of a finished session in the
window (ms): its state parked on the host."""
from bench.harness import readers


def read(run):
    return readers.mean((e["end"] - e["start"]) * 1e3 for e in run.evicts)
