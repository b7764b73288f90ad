"""``flash_decode``: decode attention over a cache's live prefix
(``repro_torch/kernels/flash_decode.py``, ``csrc/flash_decode.cu``).

* ``DEVICE_NAME``: a part of its device kernels' names in a trace;
* ``launches()``: the program's count of its launches;
* ``work(...)``: ``(flops, bytes)`` of one call, the program's
  ``bound_flops`` / ``bound_bytes`` frozen over plain integers.
"""
from __future__ import annotations

DEVICE_NAME = "flash_decode"


def launches() -> int:
    from repro_torch.kernels import flash_decode
    return flash_decode.flash_decode_attention.launches


def work(live_keys: int, B: int, H: int, KH: int, D: int, *,
         elem: int = 2) -> tuple:
    """One decode query a row: ``4 * D`` a live key and query head; the
    live prefix of both caches read once, q read and the output written
    once.  ``live_keys`` is summed over the batch's rows."""
    flops = 4 * H * D * live_keys
    nbytes = 2 * KH * live_keys * D * elem + 2 * B * H * D * elem
    return flops, nbytes
