"""Model FLOPs of the work the traced stretch completed over the stretch
at the bf16 peak (%), both on the serving loop's clock."""
from bench.harness import readers


def read(run):
    return readers.mfu_pct(run)
