"""flash_decode's share of its roofline over the traced stretch (%): the bound
time of the work the stretch's steps, admissions and hand-offs needed of
it over its device time."""
from bench.harness import readers


def read(run):
    return readers.roofline_pct(run, "flash_decode")
