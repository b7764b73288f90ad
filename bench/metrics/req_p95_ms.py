"""95th percentile over every request due in the window of its completion
less its due time (ms); a request never served counts in ``failed``."""
from bench.harness import readers


def read(run):
    return readers.quantile(readers.request_latencies_ms(run), 0.95)
