"""The traced stretch less the union of the device's kernel, copy and set
intervals in it, over the stretch (%)."""
from bench.harness import readers


def read(run):
    return readers.idle_pct(run)
