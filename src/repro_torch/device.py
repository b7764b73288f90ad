"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to the card.  Asking for
CUDA on a host without it raises: nothing carries on on the CPU quietly.
The CPU runs only where a caller names it (the tests do).
"""
from __future__ import annotations

import torch

from repro_torch.core import timing


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work on the current stream, where the
    port launches all of it (a no-op on the CPU), so a host clock read
    after it measures the work and not only its launches.  Not the whole
    device: while the serving thread captures a decode stage in a CUDA
    graph (``core.graphs``), a wait on the device from another thread (a
    standby build's) would be refused.  Recorded as a ``wait`` span and
    counted as ``syncs``, on the CPU too."""
    with timing.span("wait"):
        timing.count("syncs")
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
