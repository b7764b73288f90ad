"""Frozen work formulas of the port's four hand-written kernels.

Copies of the ``bound_flops`` / ``bound_bytes`` functions beside each
kernel (``repro_torch/kernels/*.py``), rewritten over plain integers so
that the benchmark applies them to the shapes its own traffic implies and
a later change to the program cannot move its own yardstick.  Each
function returns ``(flops, bytes)`` of one call.

A kernel's bound time is the larger of ``flops / PEAK_FLOPS`` and
``bytes / PEAK_BYTES``: NVIDIA's data-sheet peaks of one H100 SXM (dense
bf16 without sparsity; HBM3), as ``repro_torch/core/hardware.py`` states
them.  The scans' operations are f32 work outside the tensor cores, so
against the bf16 peak they never bind and their bound is their bytes.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12         # HBM3, bytes/s

MAMBA1_FLOPS_PER_STATE_STEP = 6   # dt*A, decay*h, (dt*x)*B, +, h*C, sum
SSD_CHUNK = 64                    # the SSD kernel's chunk (its matmul form)


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def mamba1_scan(B: int, S: int, Di: int, N: int, *, h0: bool,
                x_bytes: int = 2, bc_bytes: int = 2) -> tuple:
    """dt and x read and y written once, B and C read once, A read, the
    f32 state read (when given) and written."""
    state = B * Di * N * 4
    nbytes = (3 * B * S * Di * x_bytes + 2 * B * S * N * bc_bytes
              + Di * N * 4 + state * (2 if h0 else 1))
    return MAMBA1_FLOPS_PER_STATE_STEP * B * S * Di * N, nbytes


def ssd_scan(B: int, S: int, H: int, P: int, N: int, *, h0: bool,
             dt_bytes: int = 4, bc_bytes: int = 2, x_bytes: int = 2) -> tuple:
    """The chunked matmul form's operations (C B^T and M x over the
    in-chunk pairs, C h^T and the state update); dt, B and C read once, x
    read and y written once, A read, the f32 state read (when given) and
    written."""
    L = min(SSD_CHUNK, S)
    flops = B * H * (2 * S * L * (N + P) + 4 * S * P * N)
    state = B * H * P * N * 4
    nbytes = (B * S * H * dt_bytes + 2 * B * S * N * bc_bytes
              + 2 * B * S * H * P * x_bytes + H * 4
              + state * (2 if h0 else 1))
    return flops, nbytes


def causal_pairs(Sq: int, Sk: int) -> int:
    """Live (query, key) pairs of one head of a causal attention whose
    queries are the last ``Sq`` of ``Sk`` positions."""
    off = Sk - Sq
    return sum(min(off + i + 1, Sk) for i in range(Sq))


def flash_attention(B: int, Sq: int, Sk: int, H: int, KH: int, D: int, *,
                    causal: bool = True, elem: int = 2) -> tuple:
    """``4 * D`` a live pair and head; q, k and v read once and the
    output written once."""
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    flops = 4 * D * B * H * pairs
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KH * D) * elem
    return flops, nbytes


def flash_decode(live_keys: int, B: int, H: int, KH: int, D: int, *,
                 elem: int = 2) -> tuple:
    """One decode query a row: ``4 * D`` a live key and query head; the
    live prefix of both caches read once, q read and the output written
    once.  ``live_keys`` is summed over the batch's rows."""
    flops = 4 * H * D * live_keys
    nbytes = 2 * KH * live_keys * D * elem + 2 * B * H * D * elem
    return flops, nbytes
