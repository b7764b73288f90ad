"""Mamba-1 selective scan with diagonal A: the recurrence of every mamba1
layer, in the prefill, each decode step and the masked recompute.

Replaces the Pallas TPU kernel ``mamba1_scan``
(``src/repro/kernels/mamba_scan.py``; oracle
``repro/kernels/ref.py:mamba1_scan_ref``).  On the card it is the
hand-written CUDA kernel in ``repro_torch/csrc/mamba_scan.cu``; on a CPU
tensor the wrapper runs the plain PyTorch version below.

What bounds it on an H100: every (b, t, d, n) needs one exponential on
the special-function unit (``bound_exps``, at ``H100_EXP_RATE``) beside
six f32 operations (``bound_flops``), and dt, x and y move 2 bytes an
element in bf16 (``bound_bytes``).  A served prefill (Di 8192, N 16, 1024
tokens) is bound by its exps (32 us, against 15 us of bytes); a decode
step, moving the ~1.6 MB of state, by bytes.  The kernel is chunk-parallel
in time: chunks of ``CHUNK`` steps from t = 0, and three launches (chunk
states, a carry over the chunks, outputs) through scratch this wrapper
allocates, or only the last when S <= ``CHUNK`` (``plan``, chosen here and
passed to the kernel library).

Contract (the Pallas kernel's, held by both versions):

* dt, x ``(B, S, Di)``; Bc, Cc ``(B, S, N)``; all four f32 or all bf16,
  the last dimension contiguous (views with other strides are taken as
  they are); A ``(Di, N)`` f32; h0 ``(B, Di, N)`` f32 or None (zeros);
* ``h_t = exp(dt_t * A) * h + (dt_t * x_t) * B_t`` and
  ``y_t = sum_n h_t * C_t`` with every input cast to f32 first;
* returns y ``(B, S, Di)`` in x's dtype and the final h ``(B, Di, N)`` f32;
* dt = 0 leaves h unchanged (the masked recompute's padded steps); the
  kernel's final state is then bit-equal to the live scan's at any live
  length.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.distributed.op_analysis import counted_kernel

CHUNK = 64                  # steps a chunk (kL in the .cu)
TILE_S = 32                 # time steps staged a tile (kTS in the .cu)
CHANNELS = 64               # channels a chunk block (kC)
# states a thread (N / that threads a channel) of the chunk-state pass, of
# the outputs pass over several chunks, and of the outputs pass alone
# (kGState, kGScan, kGStep)
STATES_A_THREAD = {"state": 8, "scan": 8, "step": 2}
CARRY_THREADS = 256         # carry kernel: (d, n) states a block
STATE_SIZES = (4, 8, 16, 32)    # N the kernel takes
FLOPS_PER_STATE_STEP = 6    # dt*A, decay*h, (dt*x)*B, +, h*C, sum over n


def n_chunks(S: int) -> int:
    """Chunks of ``CHUNK`` steps a call of S steps covers (one at least):
    chunk c holds steps [c * CHUNK, (c + 1) * CHUNK), whatever S is."""
    return max(1, -(-S // CHUNK))


def plan(B: int, S: int, Di: int, N: int,
         itemsize: int = 2) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """The launches of one call, in order: ``(pass, grid, threads,
    static shared bytes)``; ``itemsize`` is x's element size.  Several
    chunks take three launches, one chunk (S <= ``CHUNK``) only the last.
    The chunk-state and chunk-scan passes are instantiations of one
    template, ``mamba1_chunk_kernel``, with their own states a thread
    (``STATES_A_THREAD``)."""
    nc = n_chunks(S)
    blocks = -(-Di // CHANNELS)

    def threads(kind):
        return CHANNELS * N // min(STATES_A_THREAD[kind], N)
    if nc == 1:
        return [("mamba1_chunk_scan_kernel", (blocks, 1, B), threads("step"),
                 shared_bytes(N, itemsize, True))]
    return [("mamba1_chunk_state_kernel", (blocks, nc - 1, B),
             threads("state"), shared_bytes(N, itemsize, False)),
            ("mamba1_carry_kernel", (-(-Di * N // CARRY_THREADS), B),
             CARRY_THREADS, 0),
            ("mamba1_chunk_scan_kernel", (blocks, nc, B), threads("scan"),
             shared_bytes(N, itemsize, True))]


def shared_bytes(N: int, itemsize: int, outputs: bool) -> int:
    """Static shared memory of a chunk block: a tile of dt and x (and, in
    the outputs pass, y) in x's type, and of B and C in f32."""
    return TILE_S * ((3 if outputs else 2) * CHANNELS * itemsize + 2 * N * 4)


def scratch_floats(B: int, S: int, Di: int, N: int) -> int:
    """f32 scratch of a call: an N-state and a sum of dt for every (b,
    chunk, d) when there are several chunks, else 0."""
    nc = n_chunks(S)
    return 0 if nc == 1 else B * nc * Di * (N + 1)


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
    """f32 operations the recurrence needs besides its exponentials:
    ``FLOPS_PER_STATE_STEP`` for each (b, t, d, n)."""
    B, S, Di = x.shape
    return FLOPS_PER_STATE_STEP * B * S * Di * Bc.shape[-1]


def bound_exps(x, Bc) -> int:
    """Exponentials the recurrence needs: one ``exp(dt * A)`` for each
    (b, t, d, n)."""
    B, S, Di = x.shape
    return B * S * Di * Bc.shape[-1]


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
    if n_chunks(S) >= 2 ** 16 or B >= 2 ** 16:
        raise ValueError(f"{n_chunks(S)} chunks and batch {B} must each be "
                         f"under 65536 (grid dimensions)")


def work(dt, Bc, Cc, x, A, h0=None):
    """``(flops, bytes)`` of one call: ``bound_flops`` (the recurrence's
    f32 operations) and ``bound_bytes``, what ``distributed.op_analysis``
    counts for it."""
    return bound_flops(x, Bc), bound_bytes(dt, Bc, x, h0 is not None)


@counted_kernel(work)
def mamba1_scan(dt, Bc, Cc, x, A, h0=None):
    """dt/x: (B, S, Di); Bc/Cc: (B, S, N); A: (Di, N); h0: (B, Di, N) or
    None.  Returns (y (B, S, Di) in x's dtype, h (B, Di, N) f32).

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel (counted in ``mamba1_scan.launches``) on the current stream, or
    raises: there is no fallback.  Meta tensors (a dry run's shapes) give
    the outputs' shapes and launch nothing."""
    _check(dt, Bc, Cc, x, A, h0)
    tensors = (dt, Bc, Cc, x, A) + (() if h0 is None else (h0,))
    if all(t.is_meta for t in tensors):
        B, S, Di = x.shape
        return torch.empty_like(x), torch.empty(
            (B, Di, Bc.shape[2]), dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return mamba1_scan_plain(dt, Bc, Cc, x, A, h0)
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
    chunked = n_chunks(S) > 1        # the three launches of ``plan``
    scratch = torch.empty(scratch_floats(B, S, Di, N), dtype=torch.float32,
                          device=x.device) if chunked else None
    strides = (ctypes.c_int64 * 8)(dt.stride(0), dt.stride(1), x.stride(0),
                                   x.stride(1), Bc.stride(0), Bc.stride(1),
                                   Cc.stride(0), Cc.stride(1))
    fn = lib.mamba1_scan_bf16 if x.dtype == torch.bfloat16 \
        else lib.mamba1_scan_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), x.data_ptr(),
             A.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h.data_ptr(),
             # nk: allow[NK03]: ``chunked`` is the host plan's flag
             None if scratch is None else scratch.data_ptr(), int(chunked),
             B, S, Di, N, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba1_scan kernel launch failed: "
                           f"cudaError_t {err}")
    mamba1_scan.launches += 1
    return y, h


mamba1_scan.launches = 0
