"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor (``repro_torch.kernels.build``).

Each wrapper counts the launches it makes in its ``.launches`` attribute
(``launched``).  A call made while the calling thread captures a CUDA
graph (``tallied``) launches nothing: it is tallied for the graph
instead, and every replay of the graph adds the tally
(``core.graphs.StageGraph``), so ``.launches`` stays the count of kernels
the card ran."""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

_capture = threading.local()


def launched(wrapper) -> None:
    """Count one launch of ``wrapper`` (a kernel wrapper with a
    ``launches`` attribute), or tally it where this thread is capturing."""
    tally = getattr(_capture, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally[wrapper] = tally.get(wrapper, 0) + 1


@contextlib.contextmanager
def tallied() -> Iterator[Dict[object, int]]:
    """Within the block, this thread's kernel calls are tallied in the
    dict it yields (wrapper -> calls) and not counted as launches."""
    tally: Dict[object, int] = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None
