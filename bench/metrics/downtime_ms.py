"""Mean over the window's repartitions of the serving loop's blocked wall
around ``PipelineManager.repartition`` plus the link time the benchmark
prices for the bytes the hand-off moved (ms)."""
from bench.harness import readers


def read(run):
    return readers.downtime_ms(run)
