"""The share of the traced stretch in which the device idled while the
serving thread was inside a program span and not in a ``wait`` (%)."""
from bench.harness import spans


def read(run):
    return spans.idle_host_pct(run)
