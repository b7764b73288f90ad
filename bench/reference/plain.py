"""Pieces the families' plain references share (``bench/families/<family>/
reference.py``): every product in f32 with TF32 off, the selective scans in
f64, RoPE, causal softmax attention in blocks of queries, and the reading
of a weight tree by path.  Nothing here imports the program (``jax``,
``repro`` or ``repro_torch``)."""
from __future__ import annotations

import contextlib
import math

import torch

SCAN_CHUNK = 64              # longest chunk of the f64 scan
SCAN_LOG_LIMIT = 600.0       # largest in-chunk log decay exp() may take


@contextlib.contextmanager
def no_tf32():
    """Every f32 product in full f32 (the card's default may run them in
    TF32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def as_f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def causal_conv(x, w, b):
    """Depthwise causal conv over time.  x (S, C), w (K, C), b (C)."""
    S = x.shape[0]
    K = w.shape[0]
    xp = torch.cat([x.new_zeros((K - 1, x.shape[1])), x], 0)
    y = b.expand(S, -1).clone()
    for k in range(K):
        y = y + xp[k:k + S] * w[k]
    return y


def chunk_bounds(step_decay: torch.Tensor):
    """Chunk boundaries over time such that no chunk's summed decay
    (``step_decay[t]``, the largest ``-log`` decay of step t) passes
    ``SCAN_LOG_LIMIT`` and no chunk is longer than ``SCAN_CHUNK``."""
    d = step_decay.double().cpu().tolist()
    bounds, start, acc = [], 0, 0.0
    for t, v in enumerate(d):
        if t > start and (t - start >= SCAN_CHUNK
                          or acc + v > SCAN_LOG_LIMIT):
            bounds.append((start, t))
            start, acc = t, 0.0
        acc += v
    bounds.append((start, len(d)))
    return bounds


def linear_scan(log_decay, inject, readout, h, bounds):
    """``h_t = exp(log_decay(c)_t) h_{t-1} + inject(c)_t`` over each chunk
    ``c`` of ``bounds``, in f64, in closed form: ``h_t = e^{A_t} (h_0 +
    sum_{s <= t} e^{-A_s} u_s)`` with ``A`` the in-chunk cumulative log
    decay, bounded by ``chunk_bounds``.  ``readout(c, H)`` maps the chunk's
    states ``H`` (T, *state) to its outputs.  Returns (outputs, h)."""
    ys = []
    for c in bounds:
        cum = torch.cumsum(log_decay(c), 0)
        acc = torch.cumsum(torch.exp(-cum) * inject(c), 0)
        H = torch.exp(cum) * (h + acc)
        ys.append(readout(c, H))
        h = H[-1]
    return torch.cat(ys, 0), h


def rope(x, theta):
    """Rotary embedding of x (S, H, D) at positions 0..S-1, the two halves
    of each head rotated together."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q, k, v, q_rows=1024):
    """Causal softmax attention of q (S, H, D) over k and v (S, KH, D),
    each KV head serving ``H / KH`` query heads; queries in blocks of
    ``q_rows`` so that the scores fit memory.  Returns (S, H, D)."""
    S, H, hd = q.shape
    k = k.repeat_interleave(H // k.shape[1], 1)
    v = v.repeat_interleave(H // v.shape[1], 1)
    out = torch.empty((S, H, hd), dtype=q.dtype, device=q.device)
    for q0 in range(0, S, q_rows):
        q1 = min(S, q0 + q_rows)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) / math.sqrt(hd)
        live = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        s = s.masked_fill(~live, float("-inf")).softmax(-1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", s, v[:q1])
    return out


def leaf(tree, path):
    """The tensor at ``path`` (keys joined by ``/``) of a weight tree."""
    for k in path.split("/"):
        tree = tree[k]
    return tree
