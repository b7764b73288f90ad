"""Mamba-2 SSD scan with a scalar A per head: the recurrence of every
mamba2 layer, in the prefill, each decode step and the masked recompute.

Replaces the Pallas TPU kernel ``ssd_scan``
(``src/repro/kernels/ssd_scan.py``; its oracle is the sequential
``repro/models/ssm.py:mamba2_scan``).  On the card it is the hand-written
CUDA kernel in ``repro_torch/csrc/ssd_scan.cu``; on a CPU tensor the
wrapper runs the plain PyTorch version below.

What bounds it on an H100: at the served shapes (H 112, P 64, N 64, bf16)
a 1024-token prefill moves ~32 MB and does ~3.8 GFLOP in the chunked
matmul form (``bound_bytes``, ``bound_flops``), so it is bound by
device-memory bytes; a decode step moves the ~3.7 MB of state.  A call
takes one of three paths (``path``, chosen here and passed to the kernel
library): the decode step (S = 1) streams the state through a grid over
(b, h, row tiles of P); any longer call at the instantiated width runs
three chunk-parallel launches (chunk states, state passing, chunk scan)
through scratch the wrapper allocates (``scratch_floats``); other widths
run one block per (b, h) walking the chunks in order.  ``plan`` and
``shared_bytes`` state the launches exactly, for the tests.

Contract (the Pallas kernel's, held by both versions):

* dt ``(B, S, H)`` (cast to f32; the model's dt is f32); Bc, Cc
  ``(B, S, N)`` and x ``(B, S, H, P)`` all f32 or all bf16, the last
  dimension contiguous (views with other strides are taken as they are);
  A ``(H,)`` f32; h0 ``(B, H, P, N)`` f32 or None (zeros);
* per step, with every input in f32: ``h = exp(dt_t A) h + (dt_t x_t) B_t``
  and ``y_t = h C_t``;
* returns y ``(B, S, H, P)`` in x's dtype and the final h
  ``(B, H, P, N)`` f32;
* dt = 0 leaves h unchanged (the masked recompute's padded steps).
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.distributed.op_analysis import counted_kernel
from repro_torch.kernels import launched

THREADS = 256               # sequential kernel's threads (kThreads)
CHUNK = 64                  # steps a chunk (kL in the .cu)
STEP_ROWS = 8               # decode step: rows of P a block (kStepRows)
CHUNK_THREADS = 128         # chunk kernels' threads (kCThreads)
PASS_THREADS = 256          # state pass's threads, 4 floats each
CHUNKED = ((64, 64),)       # (P, N) the chunk kernels are built for
PATHS = ("step", "chunked", "sequential")   # the .cu's path numbers
_PAD = 8                    # chunk kernels' row padding (elements)
_SMEM_LIMIT = 232_448       # dynamic shared memory a block may use (bytes)


def path(S: int, P: int, N: int) -> str:
    """``"step"`` (S = 1), ``"chunked"`` (S > 1 at a width in ``CHUNKED``,
    one chunk when S <= CHUNK) or ``"sequential"``: the kernels a call
    launches."""
    if S == 1:
        return "step"
    if (P, N) in CHUNKED:
        return "chunked"
    return "sequential"


def plan(B: int, S: int, H: int, P: int, N: int,
         itemsize: int = 2) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """The launches of one call, in order: ``(kernel, grid, threads,
    dynamic shared bytes)``; ``itemsize`` is x's element size."""
    kind = path(S, P, N)
    if kind == "step":
        return [("ssd_step_kernel", (B * H, -(-P // STEP_ROWS)),
                 32 * STEP_ROWS, 0)]
    if kind == "sequential":
        return [("ssd_scan_kernel", (B * H,), THREADS,
                 shared_bytes(P, N))]
    nc = -(-S // CHUNK)
    state, scan = _chunk_shared(P, N, itemsize)
    return [("ssd_chunk_state_kernel", (B * H, nc), CHUNK_THREADS, state),
            ("ssd_state_pass_kernel",
             (B * H, -(-P * N // (4 * PASS_THREADS))), PASS_THREADS, 0),
            ("ssd_chunk_scan_kernel", (B * H, nc), CHUNK_THREADS, scan)]


def shared_bytes(P: int, N: int) -> int:
    """Dynamic shared memory of a sequential block (``smem_floats`` in the
    .cu): B, C^T, x and M^T of a chunk, the state, three f32 vectors of a
    chunk and its f64 cumsum."""
    L = CHUNK
    return 4 * (L * N + N * L + L * P + L * L + N * P + 5 * L)


def _chunk_shared(P: int, N: int, itemsize: int) -> Tuple[int, int]:
    """Dynamic shared memory of the chunk-state and chunk-scan blocks
    (``Chunk`` in the .cu): padded tiles of x's type and three vectors of
    a chunk (dt and a third in f32, the cumsum in f64)."""
    L = CHUNK
    XP, NP, LP = P + _PAD, N + _PAD, L + _PAD
    vecs = (4 + 8 + 4) * L
    state = itemsize * (L * XP + L * NP) + vecs
    scan = itemsize * (2 * L * NP + L * XP + P * NP + L * LP) + vecs
    return state, scan


def scratch_floats(B: int, S: int, H: int, P: int, N: int) -> int:
    """f32 scratch of a chunked call: a P x N state and a decay for every
    (b, h, chunk); 0 on the other paths."""
    if path(S, P, N) != "chunked":
        return 0
    return B * H * -(-S // CHUNK) * (P * N + 1)


def bound_bytes(dt, Bc, x, h0_given: bool = True) -> int:
    """Bytes the function must move: dt, B and C read once, x read and y
    written once, A read, h0 read (when given) and h written."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    state = B * H * P * N * 4
    return (dt.numel() * dt.element_size()
            + 2 * B * S * N * Bc.element_size()
            + 2 * B * S * H * P * x.element_size() + H * 4
            + state * (2 if h0_given else 1))


def bound_flops(x, Bc, chunk: int = CHUNK) -> int:
    """Operations of the chunked matmul form at ``chunk`` (the kernel's),
    for every (b, h): C B^T and M x over the in-chunk pairs
    (2 * S * L * N and 2 * S * L * P), C h^T and the state update
    (2 * S * P * N each), with L = min(chunk, S)."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    L = min(chunk, S)
    return B * H * (2 * S * L * (N + P) + 4 * S * P * N)


# ---------------------------------------------------------------------------
# plain PyTorch version: the CPU path and the kernel's oracle
# ---------------------------------------------------------------------------

def ssd_scan_plain(dt, Bc, Cc, x, A, h0=None):
    """The kernel's function in plain PyTorch: the sequential recurrence in
    f32, one step at a time (``repro/models/ssm.py:mamba2_scan``'s step),
    y cast to x's dtype as the kernel writes it."""
    B, S, H = dt.shape
    P, N = x.shape[-1], Bc.shape[-1]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    Af = A.float()
    dtf, bf, cf, xf = dt.float(), Bc.float(), Cc.float(), x.float()
    ys = []
    for t in range(S):
        dt_t = dtf[:, t]                                     # (B, H)
        decay = torch.exp(dt_t * Af)[:, :, None, None]
        upd = (dt_t[:, :, None] * xf[:, t])[..., None] \
            * bf[:, t, None, None, :]
        h = decay * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((B, 0, H, P))
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _check(dt, Bc, Cc, x, A, h0) -> None:
    if dt.dim() != 3 or x.dim() != 4 or x.shape[:3] != dt.shape:
        raise ValueError(f"dt must be (B, S, H) and x (B, S, H, P), got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    B, S, H, P = x.shape
    if Bc.dim() != 3 or Bc.shape != Cc.shape or Bc.shape[:2] != (B, S):
        raise ValueError(f"Bc and Cc must share one ({B}, {S}, N) shape, "
                         f"got {tuple(Bc.shape)}, {tuple(Cc.shape)}")
    N = Bc.shape[2]
    if tuple(A.shape) != (H,):
        raise ValueError(f"A must be ({H},), got {tuple(A.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"h0 must be ({B}, {H}, {P}, {N}), got "
                         f"{tuple(h0.shape)}")
    if not (Bc.dtype == Cc.dtype == x.dtype) \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Bc, Cc and x must all be float32 or all bfloat16, "
                        f"got {Bc.dtype}, {Cc.dtype}, {x.dtype}")


def _check_launchable(dt, Bc, Cc, x, A, h0) -> None:
    """What the kernel itself needs beyond ``_check``: f32 A and h0, P and
    N multiples of 4 whose chunk buffers fit in shared memory, contiguous
    last dimensions, and a non-empty grid."""
    B, S, H, P = x.shape
    N = Bc.shape[2]
    if P % 4 or N % 4 or P == 0 or N == 0:
        raise ValueError(f"head_dim {P} and d_state {N} must be positive "
                         f"multiples of 4")
    need = max(smem for *_, smem in plan(B, S, H, P, N, x.element_size()))
    if need > _SMEM_LIMIT:
        raise ValueError(f"P={P}, N={N} needs {need} bytes of shared memory "
                         f"(> {_SMEM_LIMIT})")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError(f"A and h0 must be float32, got {A.dtype}, "
                        f"{None if h0 is None else h0.dtype}")
    for name, t in (("Bc", Bc), ("Cc", Cc), ("x", x)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension, got strides {t.stride()}")
    if B == 0 or H == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}")
    if S >= 2 ** 31 or B * H >= 2 ** 31:
        raise ValueError("S and B * H must fit in 32 bits")


def work(dt, Bc, Cc, x, A, h0=None):
    """``(flops, bytes)`` of one call: ``bound_flops`` and
    ``bound_bytes``, what ``distributed.op_analysis`` counts for it."""
    return bound_flops(x, Bc), bound_bytes(dt, Bc, x, h0 is not None)


@counted_kernel(work)
def ssd_scan(dt, Bc, Cc, x, A, h0=None):
    """dt: (B, S, H); Bc/Cc: (B, S, N); x: (B, S, H, P); A: (H,); h0:
    (B, H, P, N) or None.  Returns (y (B, S, H, P) in x's dtype,
    h (B, H, P, N) f32).

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel (counted in ``ssd_scan.launches``) on the current stream, or
    raises: there is no fallback.  Meta tensors (a dry run's shapes) give
    the outputs' shapes and launch nothing."""
    _check(dt, Bc, Cc, x, A, h0)
    tensors = (dt, Bc, Cc, x, A) + (() if h0 is None else (h0,))
    if all(t.is_meta for t in tensors):
        B, S, H, P = x.shape
        return torch.empty_like(x), torch.empty(
            (B, H, P, Bc.shape[2]), dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return ssd_scan_plain(dt, Bc, Cc, x, A, h0)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"dt, Bc, Cc, x, A and h0 must lie on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    _check_launchable(dt, Bc, Cc, x, A, h0)
    B, S, H, P = x.shape
    N = Bc.shape[2]
    dt = dt.float()
    A = A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    from repro_torch.kernels import build
    lib = build.load()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    kind = path(S, P, N)
    n_scratch = scratch_floats(B, S, H, P, N)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device) \
        if n_scratch else None
    strides = (ctypes.c_int64 * 10)(*dt.stride(), Bc.stride(0), Bc.stride(1),
                                    Cc.stride(0), Cc.stride(1),
                                    *x.stride()[:3])
    fn = lib.ssd_scan_bf16 if x.dtype == torch.bfloat16 \
        else lib.ssd_scan_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), x.data_ptr(),
             A.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             PATHS.index(kind), B, S, H, P, N, strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"cudaError_t {err}")
    launched(ssd_scan)
    return y, h


ssd_scan.launches = 0
