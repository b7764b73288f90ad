"""Mean over the traced stretch's decode steps (the program's ``step``
spans) of their wall less the ``wait`` spans below them (ms): what the
host does in a step besides waiting on the device."""
from bench.harness import spans


def read(run):
    return spans.host_ms_per(run, "step")
