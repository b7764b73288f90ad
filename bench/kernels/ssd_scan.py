"""``ssd_scan``: the Mamba-2 SSD scan (``repro_torch/kernels/ssd_scan.py``,
``csrc/ssd_scan.cu``).

* ``DEVICE_NAME``: a part of its device kernels' names in a trace;
* ``launches()``: the program's count of its launches;
* ``work(...)``: ``(flops, bytes)`` of one call, the program's
  ``bound_flops`` / ``bound_bytes`` frozen over plain integers.
"""
from __future__ import annotations

DEVICE_NAME = "ssd_"
CHUNK = 64                   # the kernel's chunk (its matmul form)


def launches() -> int:
    from repro_torch.kernels import ssd_scan
    return ssd_scan.ssd_scan.launches


def work(B: int, S: int, H: int, P: int, N: int, *, h0: bool,
         dt_bytes: int = 4, bc_bytes: int = 2, x_bytes: int = 2) -> tuple:
    """The chunked matmul form's operations (C B^T and M x over the
    in-chunk pairs, C h^T and the state update); dt, B and C read once, x
    read and y written once, A read, the f32 state read (when given) and
    written."""
    L = min(CHUNK, S)
    flops = B * H * (2 * S * L * (N + P) + 4 * S * P * N)
    state = B * H * P * N * 4
    nbytes = (B * S * H * dt_bytes + 2 * B * S * N * bc_bytes
              + 2 * B * S * H * P * x_bytes + H * 4
              + state * (2 if h0 else 1))
    return flops, nbytes
