"""Plain PyTorch forwards of the benchmark's two configurations, in f32.

The reference that decides a cell's ``correct``: the whole model over one
sequence, layer by layer, every product in f32 with TF32 off, the
selective scans in f64.  It imports nothing of the program (``jax``,
``repro`` or ``repro_torch``) and takes nothing the program made: it
reads the benchmark's own weights (``bench/harness/weights.py``, made
from the seed) through ``weight``, and the configuration's ``port`` group
as a plain dict.

Architectures, as the configuration runs them (``bench/configs/*.json``
lists each departure from the published model under ``assumed``):

* ``mamba1`` (falcon-mamba-7b): pre-norm residual layers, ``x + mamba(
  rms(x))``; the block is ``in_proj`` into x and the gate z, a depthwise
  causal conv of width K with bias and SiLU, ``x_proj`` into dt (rank R),
  B and C, ``dt = softplus(dt @ dt_proj + dt_bias)``, the selective scan
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = h_t C_t + D x_t``
  gated by ``silu(z)``, then ``out_proj``; ``A = -exp(A_log)``.
* ``mamba2`` with a shared block (zamba2-7b): Mamba-2 layers (one group
  of B and C, a scalar decay a head, the gated RMSNorm over ``d_inner``
  before ``out_proj``) and, after every ``hybrid_period``-th layer, one
  shared pre-norm attention + SwiGLU MLP block (RoPE on q and k, causal
  softmax attention, heads of ``d_model / num_heads``).

Then the final RMSNorm and the LM head; logits for every position.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from bench.work.model import dims

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


def mamba1_block(p, x, g):
    di, N, R = g["di"], g["N"], g["R"]
    xin, z = (x @ p("in_proj")).split([di, di], -1)
    xc = F.silu(causal_conv(xin, p("conv_w"), p("conv_b")))
    dt, B, C = (xc @ p("x_proj")).split([R, N, N], -1)
    dt = F.softplus(dt @ p("dt_proj") + p("dt_bias")).double()
    A = -torch.exp(p("A_log")).double()                    # (di, N)
    u = dt * xc.double()                                   # (S, di)
    Bd, Cd = B.double(), C.double()
    bounds = chunk_bounds(dt.max(-1).values * A.abs().max())
    y, _ = linear_scan(
        lambda c: dt[c[0]:c[1], :, None] * A,
        lambda c: u[c[0]:c[1], :, None] * Bd[c[0]:c[1], None, :],
        lambda c, H: (H * Cd[c[0]:c[1], None, :]).sum(-1),
        torch.zeros((di, N), dtype=torch.float64, device=x.device), bounds)
    y = y.float() + xc * p("D")
    return (y * F.silu(z)) @ p("out_proj")


def mamba2_block(p, x, g):
    di, N, H, P = g["di"], g["N"], g["H"], g["P"]
    S = x.shape[0]
    z, xbc, dt = (x @ p("in_proj")).split([di, di + 2 * N, H], -1)
    xbc = F.silu(causal_conv(xbc, p("conv_w"), p("conv_b")))
    xin, B, C = xbc.split([di, N, N], -1)
    xh = xin.reshape(S, H, P)
    dt = F.softplus(dt + p("dt_bias")).double()            # (S, H)
    A = -torch.exp(p("A_log")).double()                    # (H,)
    u = dt[:, :, None] * xh.double()                       # (S, H, P)
    Bd, Cd = B.double(), C.double()
    bounds = chunk_bounds(dt.max(-1).values * A.abs().max())
    y, _ = linear_scan(
        lambda c: (dt[c[0]:c[1]] * A)[:, :, None, None],
        lambda c: u[c[0]:c[1], :, :, None] * Bd[c[0]:c[1], None, None, :],
        lambda c, Hs: (Hs * Cd[c[0]:c[1], None, None, :]).sum(-1),
        torch.zeros((H, P, N), dtype=torch.float64, device=x.device),
        bounds)
    y = y.float() + xh * p("D")[:, None]
    y = y.reshape(S, di) * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-5) * p("norm")
    return y @ p("out_proj")


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


def shared_block(p, x, g, eps, theta, q_rows=1024):
    S = x.shape[0]
    H, KH, hd = g["AH"], g["AKH"], g["hd"]
    h = rms(x, p("ln1/scale"), eps)
    q = rope((h @ p("attn/wq")).reshape(S, H, hd), theta)
    k = rope((h @ p("attn/wk")).reshape(S, KH, hd), theta)
    v = (h @ p("attn/wv")).reshape(S, KH, hd)
    k = k.repeat_interleave(H // KH, 1)
    v = v.repeat_interleave(H // KH, 1)
    out = torch.empty((S, H, hd), dtype=x.dtype, device=x.device)
    for q0 in range(0, S, q_rows):         # blocks of queries: fits memory
        q1 = min(S, q0 + q_rows)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) / math.sqrt(hd)
        live = (torch.arange(q1, device=x.device)[None, :]
                <= torch.arange(q0, q1, device=x.device)[:, None])
        s = s.masked_fill(~live, float("-inf")).softmax(-1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", s, v[:q1])
    x = x + out.reshape(S, H * hd) @ p("attn/wo")
    h = rms(x, p("ln2/scale"), eps)
    return x + (F.silu(h @ p("mlp/w_gate")) * (h @ p("mlp/w_up"))) \
        @ p("mlp/w_down")


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def forward_logits(port: dict, params: dict, tokens: torch.Tensor, *,
                   weight=as_f32) -> torch.Tensor:
    """Logits (S, V) in f32 of the whole model over ``tokens`` (S,).
    ``weight`` maps each stored weight to the f32 tensor the reference
    multiplies by (the control passes a lower precision's round trip);
    the f32 constants (``dt_bias``, ``A_log``, ``D``) are read as they
    are."""
    g = dims(port)
    eps = port.get("norm_eps", 1e-5)
    theta = port.get("rope_theta", 10_000.0)
    exact = ("dt_bias", "A_log", "D")

    def layer_weights(i):
        def p(name):
            t = _leaf(params["layers"]["mamba"], name)[i]
            return t.float() if name in exact else weight(t)
        return p

    def shared(name):
        return weight(_leaf(params["shared"], name))

    with no_tf32(), torch.no_grad():
        x = weight(params["embed"])[tokens]
        block = mamba1_block if g["kind"] == "mamba1" else mamba2_block
        for i in range(g["L"]):
            h = rms(x, weight(params["layers"]["ln"]["scale"][i]), eps)
            x = x + block(layer_weights(i), h, g)
            if g["period"] and (i + 1) % g["period"] == 0:
                x = shared_block(shared, x, g, eps, theta)
        x = rms(x, weight(params["final_norm"]["scale"]), eps)
        head = params["embed"].T if port.get("tie_embeddings") \
            else params["lm_head"]
        return x @ weight(head)
