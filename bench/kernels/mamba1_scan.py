"""``mamba1_scan``: the Mamba-1 selective scan (``repro_torch/kernels/
mamba_scan.py``, ``csrc/mamba_scan.cu``).

* ``DEVICE_NAME``: a part of its device kernels' names in a trace;
* ``launches()``: the program's count of its launches;
* ``work(...)``: ``(flops, bytes)`` of one call, the program's
  ``bound_flops`` / ``bound_bytes`` frozen over plain integers.  Its
  operations are f32 work outside the tensor cores, so against the bf16
  peak they never bind and its bound is its bytes.
"""
from __future__ import annotations

DEVICE_NAME = "mamba1_"
FLOPS_PER_STATE_STEP = 6     # dt*A, decay*h, (dt*x)*B, +, h*C, sum


def launches() -> int:
    from repro_torch.kernels import mamba_scan
    return mamba_scan.mamba1_scan.launches


def work(B: int, S: int, Di: int, N: int, *, h0: bool,
         x_bytes: int = 2, bc_bytes: int = 2) -> tuple:
    """dt and x read and y written once, B and C read once, A read, the
    f32 state read (when given) and written."""
    state = B * Di * N * 4
    nbytes = (3 * B * S * Di * x_bytes + 2 * B * S * N * bc_bytes
              + Di * N * 4 + state * (2 if h0 else 1))
    return FLOPS_PER_STATE_STEP * B * S * Di * N, nbytes
