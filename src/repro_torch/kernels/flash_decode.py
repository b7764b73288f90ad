"""Flash-decode attention: one query token against a heads-major KV cache.

Replaces the Pallas TPU kernel ``flash_decode_attention``
(``src/repro/kernels/flash_decode.py``; oracle
``repro/kernels/ref.py:decode_attention_ref``).  On the card it is the
hand-written CUDA kernel in ``repro_torch/csrc/flash_decode.cu``; on a CPU
tensor the wrapper runs the plain PyTorch version below.

What bounds it on an H100: it reads ``2 * B * KH * min(pos, S) * D`` cache
elements once and does about four flops per element, so it is bound by
device-memory bytes (``bound_bytes``).  B * KH is 2 for the served dense
model, far too few blocks for 132 SMs, so the kernel splits the live
prefix ``[0, min(pos, S))`` across ``n_split`` blocks a (row, KV head):
``split_plan`` fixes the grid from the shapes alone, each block finds its
share on the device (``slice_bounds`` mirrors the arithmetic), and the
n_split blocks of a row, one thread-block cluster, merge their f32
partials through distributed shared memory in the same launch.
``pos`` stays on the device: the hot path never waits on the host, and a
call can be captured in a CUDA graph and replayed with ``pos`` changed in
place.

Contract (the Pallas kernel's, held by both versions):

* q ``(B, 1, H, D)``; k/v ``(B, KH, S, D)``; f32 or bf16; output in q's
  dtype; G = H / KH query heads share each KV head;
* ``pos`` is the count of valid entries: a scalar shared by the batch or a
  ``(B,)`` vector per row; rows with ``pos == 0`` return exact zeros;
* a size-1 vector gives bit for bit the scalar result.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.distributed.op_analysis import counted_kernel

ALIGN_K = 16                # a slice starts at a multiple of this many
                            # keys (kAlign in the .cu)
TARGET_BLOCKS = 256         # blocks a call aims at: two an SM of 132
MAX_SPLIT = 16              # blocks a cluster, so splits a (row, KV head)
MAX_ROW_TILE = 4            # query heads a block (GT in the .cu, which
                            # compiles 1, 2 and 4)


def row_tile(G: int) -> Tuple[int, int]:
    """``(GT, RG)``: a block holds GT query heads of a GQA group in
    registers (the power of two >= G, at most ``MAX_ROW_TILE``; rows past
    G are padding), and a group of G heads takes RG row groups."""
    gt = 1
    while gt < min(G, MAX_ROW_TILE):
        gt *= 2
    return gt, -(-G // gt)


def split_plan(B: int, KH: int, S: int, row_groups: int = 1) -> int:
    """``n_split``: blocks a (row, KV head, row group) over the grid
    ``(B * KH * row_groups, n_split)``, from the shapes alone: about
    ``TARGET_BLOCKS`` blocks in all, at most ``MAX_SPLIT`` (the n_split
    blocks of a row form one thread-block cluster), and no more splits
    than ``ALIGN_K``-key units in the cache (a block past them would
    always be empty)."""
    rows = max(B * KH * row_groups, 1)
    want = max(1, min(TARGET_BLOCKS // rows, MAX_SPLIT))
    return min(want, max(1, -(-S // ALIGN_K)))


def slice_bounds(valid: int, split: int, n_split: int) -> Tuple[int, int]:
    """Keys ``[k0, k1)`` of split ``split`` when ``valid`` keys are live:
    the kernel's ``slice_of``.  The prefix is cut in ``ALIGN_K``-key units
    and split i takes units ``[i * n // n_split, (i + 1) * n // n_split)``:
    the splits cover ``[0, valid)`` once, differ by at most one unit, and
    ``k0 >= k1`` marks an empty split."""
    units = -(-valid // ALIGN_K)
    u0 = split * units // n_split
    u1 = (split + 1) * units // n_split
    return u0 * ALIGN_K, min(u1 * ALIGN_K, valid)


def _scale(D: int) -> float:
    """1/sqrt(D) rounded to f32, as the reference kernel's constant is."""
    # nk: allow[NK03]: a numpy scalar from a host int, no device value
    return float(np.float32(1.0 / math.sqrt(D)))


def _scale_log2(D: int) -> float:
    """log2(e)/sqrt(D): the kernel's exponentials are base 2."""
    # nk: allow[NK03]: a numpy scalar from a host int, no device value
    return float(np.float32(math.log2(math.e) / math.sqrt(D)))


def live_keys(q: torch.Tensor, k_cache: torch.Tensor, pos) -> int:
    """Live keys summed over the batch rows.  ``pos`` on the meta device
    (a dry run's shapes, no values) counts every row of the cache, a
    decode step against a full cache."""
    B, S = q.shape[0], k_cache.shape[2]
    if isinstance(pos, torch.Tensor) and pos.is_meta:
        return B * S
    p = torch.as_tensor(pos).reshape(-1).cpu().clamp(0, S)
    return int(p.sum()) * (B if p.numel() == 1 else 1)


def bound_bytes(q: torch.Tensor, k_cache: torch.Tensor, pos) -> int:
    """Bytes the function must move: the valid prefix of both caches read
    once, q read once, the output written once."""
    D, KH = q.shape[3], k_cache.shape[1]
    return 2 * KH * live_keys(q, k_cache, pos) * D \
        * k_cache.element_size() + 2 * q.numel() * q.element_size()


def bound_flops(q: torch.Tensor, k_cache: torch.Tensor, pos) -> int:
    """Operations the function needs: ``4 * D`` a live key and query head
    (a multiply and an add in each of q k^T and p v)."""
    _, _, H, D = q.shape
    return 4 * H * D * live_keys(q, k_cache, pos)


def work(q, k_cache, v_cache, *, pos):
    """``(flops, bytes)`` of one call: ``bound_flops`` and
    ``bound_bytes``, what ``distributed.op_analysis`` counts for it."""
    return bound_flops(q, k_cache, pos), bound_bytes(q, k_cache, pos)


# ---------------------------------------------------------------------------
# plain PyTorch version: the CPU path and the kernel's oracle
# ---------------------------------------------------------------------------

def flash_decode_attention_plain(q, k_cache, v_cache, *, pos):
    """The kernel's function in plain PyTorch (f32 arithmetic)."""
    B, _, H, D = q.shape
    KH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    pos = torch.as_tensor(pos, device=q.device).reshape(-1)
    if pos.numel() == 1:
        pos = pos.expand(B)
    valid = torch.arange(S, device=q.device)[None, :] < pos[:, None]
    s = torch.einsum("bhgd,bhkd->bhgk", q.reshape(B, KH, G, D).float(),
                     k_cache.float()) * _scale(D)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)                            # masked -> exactly 0
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    out = out / l.clamp_min(1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _check(q, k_cache, v_cache):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v caches must share one (B, KH, S, D) shape, "
                         f"got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    KH = k_cache.shape[1]
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads are not a multiple of {KH} KV "
                         f"heads")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q/k/v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def _check_launchable(q, k_cache, v_cache) -> None:
    """What the kernel itself needs beyond ``_check``: 16-byte loads along
    D, at most 32 of them a row (one a lane of a warp), and contiguous
    16-byte-aligned operands.  Its shared memory (a ring of five tiles of
    K and V, at most 160 KB at that reach) does not grow with G."""
    D = q.shape[3]
    vec = 16 // q.element_size()
    if D % vec:
        raise ValueError(f"head_dim {D} is not a multiple of {vec} "
                         f"(16-byte loads)")
    if D // vec > 32:
        raise ValueError(f"head_dim {D} needs {D // vec} 16-byte loads a "
                         f"row; a key's row takes at most 32 (one a lane)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _pos_buffer(pos, B: int, device) -> Tuple[torch.Tensor, int]:
    """``pos`` as a device int32 buffer + the per-row flag.  A size-1
    vector folds onto the scalar path (one shared entry)."""
    if isinstance(pos, torch.Tensor):
        if pos.device != device:
            raise ValueError(f"pos lies on {pos.device}, the cache on "
                             f"{device}")
        buf = pos.reshape(-1)
    else:
        # nk: allow[NK03]: a ``pos`` that is not a tensor is a host int
        buf = torch.tensor([int(pos)], device=device)
    if buf.numel() not in (1, B):
        raise ValueError(f"pos must be a scalar or ({B},), got "
                         f"{buf.numel()} entries")
    buf = buf.to(torch.int32).contiguous()
    return buf, int(buf.numel() > 1)


@counted_kernel(work)
def flash_decode_attention(q, k_cache, v_cache, *, pos):
    """q: (B, 1, H, D); k/v_cache HEADS-MAJOR (B, KH, S, D); pos: count of
    valid entries, scalar or ``(B,)``.  Returns (B, 1, H, D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel (one launch, counted in ``flash_decode_attention.launches``) on
    the current stream, or raises: there is no fallback.  Meta tensors (a
    dry run's shapes) give the output's shape and launch nothing."""
    _check(q, k_cache, v_cache)
    if q.is_meta and k_cache.is_meta and v_cache.is_meta:
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, pos=pos)
    if q.device.type != "cuda" or k_cache.device != q.device \
            or v_cache.device != q.device:
        raise ValueError(f"q/k/v must lie on one CUDA device, got "
                         f"{q.device}, {k_cache.device}, {v_cache.device}")
    _check_launchable(q, k_cache, v_cache)
    B, _, H, D = q.shape
    KH, S = k_cache.shape[1], k_cache.shape[2]
    GT, RG = row_tile(H // KH)
    from repro_torch.kernels import build
    lib = build.load()
    pos_buf, per_row = _pos_buffer(pos, B, q.device)
    n_split = split_plan(B, KH, S, RG)
    out = torch.empty_like(q)
    fn = lib.flash_decode_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_decode_f32
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pos_buf.data_ptr(), per_row, out.data_ptr(), B, H, KH, GT, S,
             D, n_split, _scale_log2(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"cudaError_t {err}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
