"""Transformer layers: norms, RoPE and sinusoidal positions, attention,
MLP and MoE.

The PyTorch counterpart of ``repro/models/layers.py``: plain functions on
tensors, params as plain dicts with the reference's keys and ``(in, out)``
weight layout (``x @ W``).  Each function keeps the reference's dtype
policy (f32 statistics and softmax, results cast back to the input dtype),
so the two packages agree on the same weights.

Attention implementations
-------------------------
``naive``   materialises the full score matrix — small-shape oracle only.
``chunked`` online softmax over KV blocks (flash-style) in plain torch,
            with a blockwise backward (``_ChunkedAttention``): the route
            that trains.
``kernel``  the hand-written flash-attention kernel
            (``repro_torch.kernels.flash_attention``; ``pallas``, the
            reference's name, is the same route): on a CPU tensor its
            wrapper runs the plain version, on a CUDA tensor the kernel.
            Forward only: it raises where an input requires a gradient.
No library attention is used.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    """Mean and (biased) variance in f32, the normalised value cast back
    to ``x``'s dtype, then scale and bias in that dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

_INV_FREQ: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """RoPE's inverse frequencies ``1 / theta ** (2i / head_dim)``, the
    reference's formula in f64 on the host cast to f32, built once per
    ``(head_dim, theta, device)`` and kept there: a decode step reads the
    table on the device and copies nothing from the host (a pageable copy
    would wait on the card mid-step and could not be captured in a CUDA
    graph)."""
    key = (int(head_dim), float(theta), torch.device(device))
    table = _INV_FREQ.get(key)
    if table is None:
        host = torch.from_numpy(
            (1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim)))
            .astype(np.float32))
        # nk: allow[NK03]: once per (head_dim, theta, device), then cached
        table = _INV_FREQ.setdefault(key, host.to(device))
    return table


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2), f32."""
    inv_freq = rope_inv_freq(head_dim, theta, positions.device)
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


def sinusoidal_positions(seq_len: int, d_model: int, device=None):
    """(seq_len, d_model) f32 sinusoidal table (whisper's absolute
    positions)."""
    return sinusoidal_at(torch.arange(seq_len, device=device), d_model)


def sinusoidal_at(pos: torch.Tensor, d_model: int):
    """pos: (...,) int -> (..., d_model) f32: sin of ``pos / 10000 **
    (2i / d_model)`` in column 2i, cos in column 2i + 1."""
    # the exponents in f32, their powers rounded once from f64 (as XLA's)
    dim = np.arange(0, d_model, 2, dtype=np.float32) / np.float32(d_model)
    denom = torch.from_numpy(
        np.power(10000.0, dim.astype(np.float64)).astype(np.float32))
    ang = pos[..., None].float() / denom.to(pos.device)
    out = torch.empty(pos.shape + (d_model,), dtype=torch.float32,
                      device=pos.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


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


def _chunked_attention_fwd_impl(q, k, v, *, causal=True, window=None,
                                q_offset=0, q_chunk=1024, kv_chunk=1024):
    """Flash-style online-softmax attention in plain torch.

    Never materialises more than (B, KH, G, q_chunk, kv_chunk) scores.
    Walks q chunks (outer) and kv chunks (inner) as the reference's scans
    do, including its static sliding-window block skip.  A kv chunk that
    lies wholly in the causal future of a q chunk is skipped too: every
    score in it is masked, so it adds exactly zero to the softmax sums and
    skipping it changes no bit of the result.  Returns ``(out, lse)``,
    ``lse`` the f32 log-sum-exp ``(B, KH, G, Sq)`` the backward reads.
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
    outs, lses = [], []
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
        l = l.clamp_min(1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    out = torch.stack(outs)                          # (nq, B, KH, G, qc, D)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * q_chunk, H, D)
    lse = torch.stack(lses, 3).reshape(B, KH, G, nq * q_chunk)
    return out[:, :Sq], lse[..., :Sq]


def _chunked_attention_bwd(q, k, v, out, lse, dout, *, causal, window,
                           q_offset, q_chunk):
    """The flash-attention backward (``_chunked_attention_bwd`` of the
    reference): q chunks over the whole key range, ``p = exp(s - lse)``
    recomputed from the saved log-sum-exp, padded query rows masked, and
    ``D = sum(dO * O)``; products in f32, ``dq, dk, dv`` in the inputs'
    dtypes."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qc = min(q_chunk, Sq)
    nq = -(-Sq // qc)
    pad_q = nq * qc - Sq
    scale = float(np.float32(1.0 / np.sqrt(D)))
    dev = q.device

    def chunks(a):                                   # (nq, B, KH, G, qc, D)
        a = F.pad(a, (0, 0, 0, 0, 0, pad_q))
        return a.reshape(B, nq, qc, KH, G, D).permute(1, 0, 3, 4, 2, 5)

    qg, og, dog = chunks(q), chunks(out), chunks(dout)
    lse_g = F.pad(lse, (0, pad_q)).reshape(B, KH, G, nq, qc)
    kf = k.float()
    vf = v.float()
    kpos = torch.arange(Sk, device=dev)
    dk = torch.zeros((B, Sk, KH, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, KH, D), dtype=torch.float32, device=dev)
    dqs = []
    for qi in range(nq):
        rows = qi * qc + torch.arange(qc, device=dev)
        qvalid = rows < Sq
        bias = _mask_bias(q_offset + rows, kpos, causal=causal,
                          window=window)
        bias = torch.where(qvalid[:, None], bias,
                           torch.full_like(bias, NEG_INF))
        qf = qg[qi].float()
        dof = dog[qi].float()
        s = torch.einsum("bhgqd,bkhd->bhgqk", qf, kf) * scale \
            + bias[None, None, None]
        p = torch.exp(s - lse_g[:, :, :, qi, :, None])  # (B, KH, G, qc, Sk)
        p = torch.where(qvalid[:, None], p, torch.zeros_like(p))
        dv += torch.einsum("bhgqk,bhgqd->bkhd", p, dof)
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dof, vf)
        d_term = (dof * og[qi].float()).sum(-1)         # (B, KH, G, qc)
        ds = p * (dp - d_term[..., None]) * scale
        dqs.append(torch.einsum("bhgqk,bkhd->bhgqd", ds, kf))
        dk += torch.einsum("bhgqk,bhgqd->bkhd", ds, qf)
    dq = torch.stack(dqs).permute(1, 0, 4, 2, 3, 5).reshape(
        B, nq * qc, H, D)[:, :Sq]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    """Flash attention with a blockwise backward (the reference's
    ``_chunked_attention_vjp``): the forward saves ``(q, k, v, out,
    lse)`` and the backward recomputes the softmax from them, so a
    training step never keeps per-chunk softmax residuals (O(Sq * Sk))."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
        out, lse = _chunked_attention_fwd_impl(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        q_chunk=q_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_attention_bwd(q, k, v, out, lse, dout,
                                            **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      q_chunk=1024, kv_chunk=1024):
    """Flash-style attention in plain torch, forward and backward
    blockwise (``_ChunkedAttention``); the forward as
    ``_chunked_attention_fwd_impl`` computes it."""
    return _ChunkedAttention.apply(q, k, v, causal, window, q_offset,
                                   q_chunk, kv_chunk)


def refuse_grad(route: str, plain: str, *tensors) -> None:
    """A kernel has no backward (nor has the reference's ``pallas_call``):
    raise where autograd would record one of ``tensors``, naming the
    plain route that trains."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"the {route} route has no backward; train "
                           f"through the plain route ({plain})")


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
        refuse_grad("flash-attention kernel", 'impl="chunked"', q, k, v)
        return FA.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def mlp(params, x, *, gated=True):
    if gated:
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


def moe_capacity(tokens: int, top_k: int, num_experts: int,
                 capacity_factor) -> int:
    """Slots per expert: ``min(max(ceil(T * K / E * cf), K), T)``, and
    ``T`` (no drops) when ``capacity_factor`` is None."""
    if capacity_factor is None:
        return tokens
    c = max(int(math.ceil(tokens * top_k / num_experts * capacity_factor)),
            top_k)
    return min(c, tokens)


def expert_counts(e: torch.Tensor, E: int) -> torch.Tensor:
    """How many entries of the int64 ``e`` name each of ``E`` experts:
    ``torch.bincount(e, minlength=E)`` as a scatter-add of ones into ``E``
    zeros, which, unlike ``bincount``, has a meta kernel (a dry run counts
    a step on meta tensors).  Integer sums: exact in any order."""
    return torch.zeros(E, dtype=torch.int64, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))


def moe_route(router, x, *, top_k, capacity_factor):
    """``moe_layer``'s routing of ``x`` (B, S, D) over the router's (D, E)
    experts, in f32: softmax, the top ``top_k`` experts of each token
    (ties to the lower expert id, as ``jax.lax.top_k``), gates
    renormalised by ``max(sum, 1e-9)``, and each of the ``T * K``
    assignments' slot in its expert's capacity (``moe_capacity``, from
    every expert's count): stably sorted by expert id, so an expert over
    its capacity drops the reference's assignments, the ones of the
    latest tokens.  A dict of the dispatch metadata ``moe_experts``
    reads, with ``weight`` each assignment's gate (0 where dropped) in
    ``x``'s dtype."""
    B, S, D = x.shape
    E = router.shape[-1]
    T, K = B * S, top_k
    dev = x.device
    logits = x.reshape(T, D).float() @ router.float()        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :K], idx[:, :K]            # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = moe_capacity(T, K, E, capacity_factor)

    # dispatch metadata: each assignment's slot in its expert's capacity
    flat_e = idx.reshape(-1)                                 # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    counts = expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * K, device=dev) - starts[flat_e[order]]
    pos_slot = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos_slot < C
    return {"probs": probs, "idx": idx, "flat_e": flat_e,
            "flat_tok": torch.arange(T * K, device=dev) // K,
            "order": order, "counts": counts, "starts": starts,
            "pos_slot": pos_slot, "keep": keep, "capacity": C,
            "weight": (gate_vals.reshape(-1) * keep).to(x.dtype)[:, None]}


def moe_experts(params, x, route, *, first: int = 0):
    """The routed experts' output for ``x`` (B, S, D) under ``route``
    (``moe_route``): each token's gated sum over its kept assignments.
    ``params`` stacks the weights of experts ``[first, first + E')``
    (all of them by default): an assignment to any other expert adds
    nothing, so the shards of an expert-parallel mesh each give their
    experts' part of the sum.

    The experts run in one of two layouts that compute the same function:
    the reference's ``(E', C, D)`` slots (every expert's weights read
    once) or, when there are at most half as many assignments as experts
    in all (a decode step), each assignment against its own expert's
    weights (only the chosen experts' weights are read)."""
    B, S, D = x.shape
    El = params["w_gate"].shape[0]
    E = route["counts"].shape[0]
    T, K = B * S, route["idx"].shape[-1]
    dev = x.device
    xf = x.reshape(T, D)
    flat_e, keep, weight = route["flat_e"], route["keep"], route["weight"]
    flat_tok, C = route["flat_tok"], route["capacity"]
    e_idx = flat_e
    if El != E:
        local = flat_e - first
        mine = (local >= 0) & (local < El)
        e_idx = torch.where(mine, local, torch.zeros_like(local))
        keep = keep & mine
        weight = weight * mine[:, None]

    if 2 * T * K <= E:
        # each assignment against its own expert's weights
        xt = xf[flat_tok][:, None]                           # (T*K, 1, D)
        h = F.silu(torch.bmm(xt, params["w_gate"][e_idx])) \
            * torch.bmm(xt, params["w_up"][e_idx])
        contrib = torch.bmm(h, params["w_down"][e_idx])[:, 0] * weight
    else:
        # the reference's (E, C, D) slots, gathered (no big scatter)
        counts = route["counts"][first:first + El]
        st = flat_tok[route["order"]]
        sel = route["starts"][first:first + El, None] \
            + torch.arange(C, device=dev)[None, :]
        valid = torch.arange(C, device=dev)[None, :] \
            < torch.clamp(counts, max=C)[:, None]
        gather_tok = torch.where(valid, st[sel.clamp(0, T * K - 1)],
                                 torch.full_like(sel, T))
        xpad = torch.cat([xf, xf.new_zeros((1, D))], 0)
        xe = xpad[gather_tok]                                # (E', C, D)
        h = F.silu(torch.bmm(xe, params["w_gate"])) \
            * torch.bmm(xe, params["w_up"])
        ye = torch.bmm(h, params["w_down"])                  # (E', C, D)
        ye = F.pad(ye, (0, 0, 0, 1))                         # trash slot
        pos_c = torch.where(keep, route["pos_slot"],
                            torch.full_like(route["pos_slot"], C))
        contrib = ye[e_idx, pos_c] * weight                  # (T*K, D)
    return contrib.reshape(T, K, D).sum(1).reshape(B, S, D)


def moe_shared(params, x):
    """The shared experts' SiLU-gated MLP."""
    shared = F.silu(x @ params["shared_w_gate"]) \
        * (x @ params["shared_w_up"])
    return shared @ params["shared_w_down"]


def moe_layer(params, x, *, top_k, capacity_factor=1.25, aux_coef=0.01):
    """Sort-based capacity-dispatch MoE (``repro.models.layers.moe_layer``)
    in one dispatch group, the reference's layout off a mesh.

    x: (B, S, D); expert weights stacked (E, D, F)/(E, F, D); the router
    (D, E) in f32.  Routing as ``moe_route``, the experts as
    ``moe_experts``, plus the shared experts where the layer has them.
    Returns ``(y, aux_loss)``, the Switch-style load-balance loss."""
    route = moe_route(params["router"], x, top_k=top_k,
                      capacity_factor=capacity_factor)
    y = moe_experts(params, x, route)

    # load-balance aux loss (Switch-style)
    probs, idx = route["probs"], route["idx"]
    E, T = probs.shape[-1], probs.shape[0]
    me = probs.mean(0)
    top1 = expert_counts(idx[:, 0], E).float() / T
    aux = aux_coef * E * torch.sum(me * top1)
    if "shared_w_gate" in params:
        y = y + moe_shared(params, x)
    return y, aux
