"""Flash attention (prefill): a block of queries against a sequence-major KV.

Replaces the Pallas TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``; oracle
``repro/kernels/ref.py:flash_attention_ref``).  On the card it is the
hand-written CUDA kernel in ``repro_torch/csrc/flash_attention.cu``; on a
CPU tensor the wrapper runs the plain PyTorch version below.

What bounds it on an H100: a causal prefill of the served models
(qwen2.5-3b H 16, KH 2, D 128; zamba2-7b H 32, KH 32, D 112; 1024 or 2048
tokens) does ``4 * D`` flops for every live (query, key) pair and moves
each element once, hundreds of flops per byte, so it is bound by
operations (``bound_flops``).  The bf16 kernel runs work items of one
(batch row, head, ``BLOCK_Q``-row query tile), two a block, longest causal
tile first (``work_items``, ``grid_plan``), each walking its live key tiles
(``key_tiles``) through a TMA-fed ring on the tensor cores; the f32 kernel
runs one block per item on the CUDA cores.  These functions state the
kernels' launch exactly, for the tests.  The reference's layout copies are
replaced by strides.

Contract (the Pallas kernel's, held by both versions):

* q ``(B, Sq, H, D)``; k/v ``(B, Sk, KH, D)``; f32 or bf16; output
  ``(B, Sq, H, D)`` in q's dtype; G = H / KH query heads share each KV head;
* query row i sits at absolute position ``q_offset + i``; key j is live for
  it when ``j <= q_offset + i`` (``causal``) and ``j > q_offset + i -
  window`` (``window`` not None);
* dead scores are the finite ``NEG_INF = -1e30``; every row with at least
  one live key gets the softmax over its live keys.  A row with none is
  not specified (no caller has one: each row sees at least its own key).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.op_analysis import counted_kernel

BLOCK_Q = 64                # query rows a work item (kBQ in the .cu)
BLOCK_K = 64                # keys a shared-memory tile (kBK in the .cu)
CONSUMERS = 2               # bf16: work items a block (kConsumers)
HEAD_DIMS = (8, 16, 32, 64, 112, 128)   # the instantiated D's
NEG_INF = -1e30
SMS = 132                   # an H100 SXM's streaming multiprocessors


def _scale(D: int) -> float:
    """1/sqrt(D) rounded to f32, as the reference kernel's constant is."""
    # nk: allow[NK03]: a numpy scalar from a host int, no device value
    return float(np.float32(1.0 / math.sqrt(D)))


def n_q_tiles(Sq: int) -> int:
    return -(-Sq // BLOCK_Q)


def work_items(B: int, Sq: int, H: int) -> List[Tuple[int, int, int]]:
    """``(b, h, q_tile)`` of every bf16 work item in launch order: item
    ``i`` takes q tile ``n_q_tiles - 1 - i // (B * H)`` of head row ``i %
    (B * H)``, so the longest causal tiles go first (``Item`` in the
    .cu)."""
    n, rows = n_q_tiles(Sq), B * H
    return [((i % rows) // H, i % H, n - 1 - i // rows)
            for i in range(rows * n)]


def grid_plan(B: int, Sq: int, H: int,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[int, ...]:
    """The launch grid.  bf16: ``(ceil(items / CONSUMERS),)``, block ``x``
    running work items ``CONSUMERS * x + c`` on its consumer warpgroups.
    f32: ``(B * H, n_q_tiles)``, block ``(bh, y)`` running q tile
    ``n_q_tiles - 1 - y`` of head row ``bh``."""
    if dtype == torch.bfloat16:
        return (-(-B * H * n_q_tiles(Sq) // CONSUMERS),)
    return B * H, n_q_tiles(Sq)


def block_items(x: int, B: int, Sq: int,
                H: int) -> List[Tuple[int, int, int]]:
    """The work items bf16 block ``x`` runs, one a consumer."""
    items = work_items(B, Sq, H)
    return items[CONSUMERS * x:CONSUMERS * (x + 1)]


def key_tiles(q_tile: int, Sq: int, Sk: int, *, causal: bool,
              window: Optional[int], q_offset: int) -> Tuple[int, int]:
    """``[lo, hi)``: the key tiles a q tile's block walks (the kernel's loop
    bounds; the Pallas kernel's tile skip).  ``hi`` stops at the tile of
    the tile's last row's causal limit, ``lo`` starts at the tile of its
    first row's window start."""
    q0 = q_tile * BLOCK_Q
    rows = min(BLOCK_Q, Sq - q0)
    k_hi = Sk
    if causal:
        k_hi = min(k_hi, q_offset + q0 + rows)
    k_lo = 0
    if window is not None:
        k_lo = max(0, q_offset + q0 - window + 1)
    return k_lo // BLOCK_K, (-(-k_hi // BLOCK_K) if k_hi > 0 else 0)


def live_pairs(Sq: int, Sk: int, *, causal: bool, window: Optional[int],
               q_offset: int) -> int:
    """Live (query, key) pairs of one (batch row, head): the work the
    function needs, whatever tiles a kernel visits."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def schedule_chain(B: int, Sq: int, Sk: int, H: int, *, causal: bool,
                   window: Optional[int], q_offset: int,
                   sms: int = SMS) -> Tuple[int, float]:
    """The bf16 schedule's longest chain against its mean, in key tiles a
    consumer walks: blocks go, in launch order, to the SM that frees first
    (one block resident an SM) and last as long as their longer item.
    Returns (the last SM's finish, the key tiles of all items over the
    ``sms * CONSUMERS`` consumers)."""
    walks = []
    for _, _, qt in work_items(B, Sq, H):
        lo, hi = key_tiles(qt, Sq, Sk, causal=causal, window=window,
                           q_offset=q_offset)
        walks.append(hi - lo)
    free = [0] * sms
    for x in range(grid_plan(B, Sq, H)[0]):
        sm = min(range(sms), key=free.__getitem__)
        free[sm] += max(walks[CONSUMERS * x:CONSUMERS * (x + 1)])
    return max(free), sum(walks) / (sms * CONSUMERS)


def bound_flops(q, k, *, causal=True, window=None, q_offset=0) -> int:
    """Operations the function needs: ``4 * D`` a live (query, key) pair
    (a multiply and an add in each of QK^T and PV), for every head."""
    B, Sq, H, D = q.shape
    return 4 * D * B * H * live_pairs(Sq, k.shape[1], causal=causal,
                                      window=window, q_offset=q_offset)


def bound_bytes(q, k) -> int:
    """Bytes the function must move: q, k and v read once, the output
    written once."""
    return (2 * q.numel() + 2 * k.numel()) * q.element_size()


# ---------------------------------------------------------------------------
# plain PyTorch version: the CPU path and the kernel's oracle
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0):
    """The kernel's function in plain PyTorch (f32 arithmetic)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        live &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        live &= kpos[None, :] > qpos[:, None] - window
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, KH, G, D).float(),
                     k.float()) * _scale(D)
    s = s.masked_fill(~live, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, window, q_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k/v one (B, Sk, KH, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    KH = k.shape[2]
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} KV "
                         f"heads")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q/k/v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def _check_launchable(q, k, v) -> None:
    """What the kernels themselves need beyond ``_check``: an instantiated
    head dim, a contiguous last dimension, and 16-byte aligned rows and
    base pointers (f32 tile loads move 16 bytes a thread; a TMA tensor
    map needs 16-byte aligned strides and base)."""
    D = q.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension, got strides {t.stride()}")
        if any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}'s strides {t.stride()} are not "
                             f"multiples of {vec} elements (16 bytes)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if max(q.shape[1], k.shape[1]) >= 2 ** 31:
        raise ValueError("sequence lengths must fit in 32 bits")


def work(q, k, v, *, causal=True, window=None, q_offset=0):
    """``(flops, bytes)`` of one call: ``bound_flops`` and
    ``bound_bytes``, what ``distributed.op_analysis`` counts for it."""
    return (bound_flops(q, k, causal=causal, window=window,
                        q_offset=q_offset), bound_bytes(q, k))


@counted_kernel(work)
def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B, Sq, H, D); k/v SEQUENCE-MAJOR (B, Sk, KH, D).  Returns
    (B, Sq, H, D) in q's dtype.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel (counted in ``flash_attention.launches``) on the current
    stream, or raises: there is no fallback.  Meta tensors (a dry run's
    shapes) give the output's shape and launch nothing."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "meta" and k.is_meta and v.is_meta:
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"q/k/v must lie on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    _check_launchable(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    from repro_torch.kernels import build
    lib = build.load()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_attention_f32
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             # nk: allow[NK03]: causal, window, q_offset are host values
             B, Sq, Sk, H, KH, D, strides, int(bool(causal)),
             # nk: allow[NK03]: (the wrapper's keyword arguments)
             0 if window is None else int(window), int(q_offset),
             n_q_tiles(Sq), _scale(D), stream)
    if err >= 999:
        raise RuntimeError(f"flash_attention: no TMA tensor map for q/k/v "
                           f"(code {err}: 999 = cuTensorMapEncodeTiled not "
                           f"found, else 1000 + its CUresult)")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
