"""Mamba-1 selective scan with diagonal A: the recurrence of every mamba1
layer, in the prefill, each decode step and the masked recompute.

Replaces the Pallas TPU kernel ``mamba1_scan``
(``src/repro/kernels/mamba_scan.py``; oracle
``repro/kernels/ref.py:mamba1_scan_ref``).  On the card it is the
hand-written CUDA kernel in ``repro_torch/csrc/mamba_scan.cu``; on a CPU
tensor the wrapper runs the plain PyTorch version below.

What bounds it on an H100: each (b, d, n) does about seven f32 operations
a step on inputs read once (``bound_flops``), and dt, x and y move 2 bytes
an element in bf16 (``bound_bytes``): a served prefill (Di 8192, N 16,
1024 tokens) moves ~50 MB, a decode step the ~1.6 MB of state, so it is
bound by device-memory bytes.  The kernel runs one thread per (b, d, n)
with h in a register for the whole sequence (``grid_plan``).

Contract (the Pallas kernel's, held by both versions):

* dt, x ``(B, S, Di)``; Bc, Cc ``(B, S, N)``; all four f32 or all bf16,
  the last dimension contiguous (views with other strides are taken as
  they are); A ``(Di, N)`` f32; h0 ``(B, Di, N)`` f32 or None (zeros);
* ``h_t = exp(dt_t * A) * h + (dt_t * x_t) * B_t`` and
  ``y_t = sum_n h_t * C_t`` with every input cast to f32 first;
* returns y ``(B, S, Di)`` in x's dtype and the final h ``(B, Di, N)`` f32;
* dt = 0 leaves h unchanged (the masked recompute's padded steps).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

THREADS = 256               # threads a block (kThreads in the .cu)
TILE_S = 32                 # time steps staged a tile (kTS in the .cu)
STATE_SIZES = (4, 8, 16, 32)    # N the kernel takes: N lanes a channel
FLOPS_PER_STATE_STEP = 7    # dt*A, exp, decay*h, (dt*x)*B, +, h*C, sum


def grid_plan(B: int, Di: int, N: int) -> Tuple[int, int]:
    """The launch grid ``(channel blocks, B)``: a block of ``THREADS``
    threads holds ``THREADS // N`` channels, one thread per state."""
    cpb = THREADS // N
    return -(-Di // cpb), B


def bound_bytes(dt, Bc, x, h0_given: bool = True) -> int:
    """Bytes the function must move: dt and x read and y written once, B
    and C read once, A read, h0 read (when given) and h written."""
    B, S, Di = x.shape
    N = Bc.shape[-1]
    e = x.element_size()
    state = B * Di * N * 4
    return (3 * B * S * Di * e + 2 * B * S * N * Bc.element_size()
            + Di * N * 4 + state * (2 if h0_given else 1))


def bound_flops(x, Bc) -> int:
    """f32 operations the recurrence needs: ``FLOPS_PER_STATE_STEP`` for
    each (b, t, d, n)."""
    B, S, Di = x.shape
    return FLOPS_PER_STATE_STEP * B * S * Di * Bc.shape[-1]


# ---------------------------------------------------------------------------
# plain PyTorch version: the CPU path and the kernel's oracle
# ---------------------------------------------------------------------------

def mamba1_scan_plain(dt, Bc, Cc, x, A, h0=None):
    """The kernel's function in plain PyTorch: the sequential recurrence in
    f32, one step at a time."""
    B, S, Di = x.shape
    N = Bc.shape[-1]
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    Af = A.float()
    dtf, bf, cf, xf = dt.float(), Bc.float(), Cc.float(), x.float()
    ys = []
    for t in range(S):
        dt_t = dtf[:, t]                                     # (B, Di)
        h = torch.exp(dt_t[..., None] * Af) * h \
            + (dt_t * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((B, 0, Di))
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _check(dt, Bc, Cc, x, A, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"dt and x must share one (B, S, Di) shape, got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    B, S, Di = x.shape
    if Bc.dim() != 3 or Bc.shape != Cc.shape or Bc.shape[:2] != (B, S):
        raise ValueError(f"Bc and Cc must share one ({B}, {S}, N) shape, "
                         f"got {tuple(Bc.shape)}, {tuple(Cc.shape)}")
    N = Bc.shape[2]
    if tuple(A.shape) != (Di, N):
        raise ValueError(f"A must be ({Di}, {N}), got {tuple(A.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, Di, N):
        raise ValueError(f"h0 must be ({B}, {Di}, {N}), got "
                         f"{tuple(h0.shape)}")
    if not (dt.dtype == Bc.dtype == Cc.dtype == x.dtype) \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dt, Bc, Cc and x must all be float32 or all "
                        f"bfloat16, got {dt.dtype}, {Bc.dtype}, {Cc.dtype}, "
                        f"{x.dtype}")


def _check_launchable(dt, Bc, Cc, x, A, h0) -> None:
    """What the kernel itself needs beyond ``_check``: f32 A and h0, a state
    size it takes, contiguous last dimensions, and a non-empty grid."""
    B, S, Di = x.shape
    N = Bc.shape[2]
    if N not in STATE_SIZES:
        raise ValueError(f"d_state {N} is not one the kernel takes "
                         f"{STATE_SIZES}")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError(f"A and h0 must be float32, got {A.dtype}, "
                        f"{None if h0 is None else h0.dtype}")
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc), ("x", x)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension, got strides {t.stride()}")
    if B == 0 or Di == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}")
    if max(S, Di) >= 2 ** 31:
        raise ValueError("S and Di must fit in 32 bits")


def mamba1_scan(dt, Bc, Cc, x, A, h0=None):
    """dt/x: (B, S, Di); Bc/Cc: (B, S, N); A: (Di, N); h0: (B, Di, N) or
    None.  Returns (y (B, S, Di) in x's dtype, h (B, Di, N) f32).

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel (counted in ``mamba1_scan.launches``) on the current stream, or
    raises: there is no fallback."""
    _check(dt, Bc, Cc, x, A, h0)
    if x.device.type == "cpu":
        return mamba1_scan_plain(dt, Bc, Cc, x, A, h0)
    tensors = (dt, Bc, Cc, x, A) + (() if h0 is None else (h0,))
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"dt, Bc, Cc, x, A and h0 must lie on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    _check_launchable(dt, Bc, Cc, x, A, h0)
    B, S, Di = x.shape
    N = Bc.shape[2]
    A = A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    from repro_torch.kernels import build
    lib = build.load()
    y = torch.empty((B, S, Di), dtype=x.dtype, device=x.device)
    h = torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 8)(dt.stride(0), dt.stride(1), x.stride(0),
                                   x.stride(1), Bc.stride(0), Bc.stride(1),
                                   Cc.stride(0), Cc.stride(1))
    fn = lib.mamba1_scan_bf16 if x.dtype == torch.bfloat16 \
        else lib.mamba1_scan_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), x.data_ptr(),
             A.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h.data_ptr(), B, S, Di, N, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba1_scan kernel launch failed: "
                           f"cudaError_t {err}")
    mamba1_scan.launches += 1
    return y, h


mamba1_scan.launches = 0
