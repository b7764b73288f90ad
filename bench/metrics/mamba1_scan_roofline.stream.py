"""mamba1_scan's share of its roofline over the traced stretch (%): the bound
time of the work the stretch's requests needed of it over its device time."""
from bench.harness import readers


def read(run):
    return readers.roofline_pct(run, "mamba1_scan")
