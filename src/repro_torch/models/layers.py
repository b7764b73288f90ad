"""Transformer layers of the dense slice: norms, RoPE, attention, MLP.

The PyTorch counterpart of ``repro/models/layers.py``: plain functions on
tensors, params as plain dicts with the reference's keys and ``(in, out)``
weight layout (``x @ W``).  Each function keeps the reference's dtype
policy (f32 statistics and softmax, results cast back to the input dtype),
so the two packages agree on the same weights.

Attention implementations
-------------------------
``naive``   materialises the full score matrix — small-shape oracle only.
``chunked`` online softmax over KV blocks (flash-style) in plain torch —
            the prefill and recompute path.  No library attention is used.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2), f32."""
    inv_freq = torch.from_numpy(
        (1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim)))
        .astype(np.float32)).to(positions.device)
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:      # (S, D/2)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                   # (B, S, D/2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _mask_bias(qpos, kpos, *, causal, window):
    """(Sq, Sk) additive bias from absolute positions."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > qpos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Oracle. q: (B,Sq,H,D) k/v: (B,Sk,KH,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    bias = _mask_bias(qpos, kpos, causal=causal, window=window)
    qg = q.reshape(B, Sq, KH, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / np.sqrt(D)
    scores = scores + bias[None, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      q_chunk=1024, kv_chunk=1024):
    """Flash-style online-softmax attention in plain torch (forward only).

    Never materialises more than (B, KH, G, q_chunk, kv_chunk) scores.
    Walks q chunks (outer) and kv chunks (inner) as the reference's scans
    do, including its static sliding-window block skip.  A kv chunk that
    lies wholly in the causal future of a q chunk is skipped too: every
    score in it is masked, so it adds exactly zero to the softmax sums and
    skipping it changes no bit of the result.
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - Sk))
    # (n, B, KH, [G,] chunk, D)
    qg = qp.reshape(B, nq, q_chunk, KH, G, D).permute(1, 0, 3, 4, 2, 5)
    kg = kp.reshape(B, nk, kv_chunk, KH, D).permute(1, 0, 3, 2, 4)
    vg = vp.reshape(B, nk, kv_chunk, KH, D).permute(1, 0, 3, 2, 4)
    scale = float(np.float32(1.0 / np.sqrt(D)))
    dev = q.device
    if window is not None and causal and nq > 1:
        n_need = min(nk, -(-(window + q_chunk) // kv_chunk) + 1)
    else:
        n_need = nk
    outs = []
    for qi in range(nq):
        qblk = qg[qi].float()                        # (B, KH, G, qc, D)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        if n_need < nk:
            kv_lo = min(max((q_offset + qi * q_chunk - window) // kv_chunk,
                            0), nk - n_need)
        else:
            kv_lo = 0
        m = torch.full((B, KH, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KH, G, q_chunk), device=dev)
        acc = torch.zeros((B, KH, G, q_chunk, D), device=dev)
        q_last = q_offset + (qi + 1) * q_chunk - 1
        for ki in range(kv_lo, kv_lo + n_need):
            if causal and ki * kv_chunk > q_last:
                break                                # wholly in the future
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            bias = _mask_bias(qpos, kpos, causal=causal, window=window)
            bias = torch.where((kpos < Sk)[None, :], bias,
                               torch.full_like(bias, NEG_INF))
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                             kg[ki].float()) * scale
            s = s + bias[None, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vg[ki].float())
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)                          # (nq, B, KH, G, qc, D)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq]


def decode_attention(q, k_cache, v_cache, *, pos, window=None):
    """One-token attention against a HEADS-MAJOR cache.

    q: (B, 1, H, D); k/v_cache: (B, KH, S, D); pos: (B,) or scalar current
    length (number of valid cache entries, including the token just
    written).  Mirrors ``repro.models.layers.decode_attention`` as it is:
    a row with ``pos == 0`` is NOT zeroed (its softmax is uniform over the
    masked scores).  f32 scores and accumulation over inputs of any dtype.
    """
    B, _, H, D = q.shape
    KH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    kpos = torch.arange(S, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    valid = kpos[None, :] < pos[:, None]                    # (B, S)
    if window is not None:
        valid &= kpos[None, :] >= pos[:, None] - window
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                     k_cache.float()) / np.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              impl="chunked", q_chunk: Optional[int] = None):
    """Full-sequence attention by ``impl``.  ``q_chunk=None`` is the
    reference's single-device default (1024)."""
    if q_chunk is None:
        q_chunk = 1024
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, q_chunk=q_chunk)
    if impl in ("kernel", "pallas"):
        raise NotImplementedError(
            "the prefill attention kernel (flash_attention) is not ported "
            "yet; use impl='chunked'")
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(params, x, *, gated=True):
    if gated:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
