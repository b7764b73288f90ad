"""``flash_attention``: prefill attention (``repro_torch/kernels/
flash_attention.py``, ``csrc/flash_attention.cu``).

* ``DEVICE_NAME``: a part of its device kernels' names in a trace;
* ``launches()``: the program's count of its launches;
* ``work(...)``: ``(flops, bytes)`` of one call, the program's
  ``bound_flops`` / ``bound_bytes`` frozen over plain integers.
"""
from __future__ import annotations

DEVICE_NAME = "flash_attention"


def launches() -> int:
    from repro_torch.kernels import flash_attention
    return flash_attention.flash_attention.launches


def causal_pairs(Sq: int, Sk: int) -> int:
    """Live (query, key) pairs of one head of a causal attention whose
    queries are the last ``Sq`` of ``Sk`` positions."""
    off = Sk - Sq
    return sum(min(off + i + 1, Sk) for i in range(Sq))


def work(B: int, Sq: int, Sk: int, H: int, KH: int, D: int, *,
         causal: bool = True, elem: int = 2) -> tuple:
    """``4 * D`` a live pair and head; q, k and v read once and the
    output written once."""
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    flops = 4 * D * B * H * pairs
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KH * D) * elem
    return flops, nbytes
