"""Flash-decode attention: one query token against a heads-major KV cache.

Replaces the Pallas TPU kernel ``flash_decode_attention``
(``src/repro/kernels/flash_decode.py``; oracle
``repro/kernels/ref.py:decode_attention_ref``).  On the card it is the
hand-written CUDA kernel in ``repro_torch/csrc/flash_decode.cu``; on a CPU
tensor the wrapper runs the plain PyTorch version below.

What bounds it on an H100: it reads ``2 * B * KH * min(pos, S) * D`` cache
elements once and does about four flops per element, so it is bound by
device-memory bytes (``bound_bytes``).  B * KH is 2 for the served model,
far too few blocks for 132 SMs, so the kernel splits the cache length
across blocks (``split_plan``) and merges the f32 partials in a second
pass.  ``pos`` stays on the device: the hot path never waits on the host.

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

TILE_K = 32                 # keys per shared-memory tile (kTileK in the .cu)
TARGET_BLOCKS = 264         # two blocks per SM of a 132-SM H100
MIN_SPLIT_KEYS = 64         # a split smaller than this costs more in
                            # partials than it saves in parallelism
_SMEM_LIMIT = 232_448       # dynamic shared memory a block may use (bytes)


def split_plan(B: int, KH: int, S: int) -> Tuple[int, int]:
    """``(n_split, chunk)``: how the cache length S is cut across blocks.

    Aims at ``TARGET_BLOCKS`` blocks over the grid ``(B * KH, n_split)``,
    never with fewer than ``MIN_SPLIT_KEYS`` keys a split; ``chunk`` is a
    multiple of ``TILE_K`` and ``n_split * chunk >= S``."""
    want = max(1, -(-TARGET_BLOCKS // max(B * KH, 1)))
    most = max(1, -(-S // MIN_SPLIT_KEYS))
    n = min(want, most)
    chunk = -(-S // n)
    chunk = -(-chunk // TILE_K) * TILE_K
    return -(-S // chunk), chunk


def _scale(D: int) -> float:
    """1/sqrt(D) rounded to f32, as the reference kernel's constant is."""
    return float(np.float32(1.0 / math.sqrt(D)))


def _shared_bytes(G: int, D: int) -> int:
    """Dynamic shared memory of the split pass (rows of q and K padded)."""
    return 4 * (G * (D + 1) + TILE_K * (D + 1) + TILE_K * D + G * D
                + G * TILE_K + 3 * G)


def bound_bytes(q: torch.Tensor, k_cache: torch.Tensor, pos) -> int:
    """Bytes the function must move: the valid prefix of both caches read
    once, q read once, the output written once."""
    B, _, H, D = q.shape
    S = k_cache.shape[2]
    KH = k_cache.shape[1]
    p = torch.as_tensor(pos).reshape(-1).cpu().clamp(0, S)
    keys = int(p.sum()) * (B if p.numel() == 1 else 1)
    return 2 * KH * keys * D * k_cache.element_size() \
        + 2 * q.numel() * q.element_size()


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
    D, contiguous 16-byte-aligned operands, and shared memory for the
    group's rows."""
    D = q.shape[3]
    G = q.shape[2] // k_cache.shape[1]
    vec = 16 // q.element_size()
    if D % vec:
        raise ValueError(f"head_dim {D} is not a multiple of {vec} "
                         f"(16-byte loads)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if _shared_bytes(G, D) > _SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D} needs {_shared_bytes(G, D)} bytes "
                         f"of shared memory (limit {_SMEM_LIMIT})")


def _pos_buffer(pos, B: int, device) -> Tuple[torch.Tensor, int]:
    """``pos`` as a device int32 buffer + the per-row flag.  A size-1
    vector folds onto the scalar path (one shared entry)."""
    if isinstance(pos, torch.Tensor):
        if pos.device != device:
            raise ValueError(f"pos lies on {pos.device}, the cache on "
                             f"{device}")
        buf = pos.reshape(-1)
    else:
        buf = torch.tensor([int(pos)], device=device)
    if buf.numel() not in (1, B):
        raise ValueError(f"pos must be a scalar or ({B},), got "
                         f"{buf.numel()} entries")
    buf = buf.to(torch.int32).contiguous()
    return buf, int(buf.numel() > 1)


def flash_decode_attention(q, k_cache, v_cache, *, pos):
    """q: (B, 1, H, D); k/v_cache HEADS-MAJOR (B, KH, S, D); pos: count of
    valid entries, scalar or ``(B,)``.  Returns (B, 1, H, D).

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel (both passes, counted once in ``flash_decode_attention.launches``)
    on the current stream, or raises: there is no fallback."""
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, pos=pos)
    if q.device.type != "cuda" or k_cache.device != q.device \
            or v_cache.device != q.device:
        raise ValueError(f"q/k/v must lie on one CUDA device, got "
                         f"{q.device}, {k_cache.device}, {v_cache.device}")
    _check_launchable(q, k_cache, v_cache)
    B, _, H, D = q.shape
    KH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    from repro_torch.kernels import build
    lib = build.load()
    pos_buf, per_row = _pos_buffer(pos, B, q.device)
    n_split, chunk = split_plan(B, KH, S)
    # one f32 scratch for the split partials: m [rows], l [rows],
    # acc [rows, D]
    rows = B * KH * n_split * G
    part = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
    part_m = part.data_ptr()
    part_l, part_acc = part_m + 4 * rows, part_m + 8 * rows
    out = torch.empty_like(q)
    fn = lib.flash_decode_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_decode_f32
    scale = _scale(D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pos_buf.data_ptr(), per_row, out.data_ptr(), part_m, part_l,
             part_acc, B, H, KH, S, D, chunk,
             n_split, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"cudaError_t {err}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
