"""The table of peaks a share of a roofline or of the peak is taken
against: NVIDIA's data-sheet peaks of one H100 SXM (dense bf16 without
sparsity; HBM3), as ``repro_torch/core/hardware.py`` states them.  A
kernel's work formula is its file's (``bench/kernels/<kernel>.py``); its
bound time is the larger of ``flops / PEAK_FLOPS`` and
``bytes / PEAK_BYTES``.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12         # HBM3, bytes/s


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
