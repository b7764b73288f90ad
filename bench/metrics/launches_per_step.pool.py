"""Device records (kernels, copies, sets) starting inside each of the
traced stretch's ``step`` spans, on the shared clock, over those steps;
steps that overlap a ``standby_build`` are left out."""
from bench.harness import spans


def read(run):
    return spans.records_per(run, "step")
