"""Mamba-1 (selective scan) and Mamba-2 (SSD) blocks.

The PyTorch counterpart of ``repro/models/ssm.py``: plain functions on
tensors, params as plain dicts with the reference's keys, shapes and
``(in, out)`` weight layout, and the reference's dtype policy
(``dt_bias``, ``A_log`` and ``D`` in f32 whatever the model dtype; the
recurrent state in f32; mamba1's dt cast to the activations' dtype before
the scan, mamba2's kept in f32).

Scan implementations (``impl``)
-------------------------------
``kernel``  the hand-written scan kernels (``repro_torch.kernels.
            mamba_scan`` / ``ssd_scan``; ``pallas``, the reference's name,
            is the same route): on a CPU tensor their wrappers run the
            plain version, on a CUDA tensor the kernel.  The default, so
            every scan on the card (prefill, decode step, masked recompute,
            stateless request) runs the kernel.  Forward only: it raises
            where an input requires a gradient, as the reference's
            ``pallas_call`` has no VJP.  The reference's prefill
            runs its jnp scan, which XLA compiles; an eager PyTorch loop
            over 1024 steps a layer would be no counterpart.
``plain``   the kernels' plain versions, the sequential recurrence in f32
            (``jnp``, the reference's name, is the same route): run only
            where a caller asks for them by name, as ``train_loss`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ssd_scan as SD
from repro_torch.models import layers as Lyr

_KERNEL = ("kernel", "pallas")
_PLAIN = ("plain", "jnp")


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C), state: (B, K-1, C).

    Accumulates in f32, adds the bias, casts to x's dtype.  Returns
    (y, new_state) where new_state holds the trailing K-1 inputs (a copy:
    a view would keep the whole padded input alive in the cache)."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((B, K - 1, C))
    xin = torch.cat([state.to(x.dtype), x], dim=1)      # (B, S+K-1, C)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + xin[:, k:k + S].float() * w[k].float()
    new_state = xin[:, S:].clone()
    return (y + b).to(x.dtype), new_state


# ---------------------------------------------------------------------------
# selective scans
# ---------------------------------------------------------------------------

def mamba1_scan(dt, Bc, Cc, x, A, h0=None, impl="kernel"):
    """h_t = exp(dt_t*A)*h_{t-1} + (dt_t*x_t) outer B_t ;  y_t = h_t . C_t

    dt, x: (B,S,Di)  Bc, Cc: (B,S,N)  A: (Di,N)  h0: (B,Di,N)
    Returns y: (B,S,Di) in x's dtype, h_final (B,Di,N) f32."""
    if impl in _KERNEL:
        Lyr.refuse_grad("mamba1_scan kernel", 'impl="plain"', dt, Bc, Cc, x,
                        A, h0)
        return MS.mamba1_scan(dt, Bc, Cc, x, A, h0=h0)
    if impl in _PLAIN:
        return MS.mamba1_scan_plain(dt, Bc, Cc, x, A, h0=h0)
    raise ValueError(f"unknown scan impl {impl!r}")


def mamba2_scan(dt, Bc, Cc, x, A, h0=None, impl="kernel"):
    """SSD with a scalar decay per head.

    dt: (B,S,H)  Bc,Cc: (B,S,N)  x: (B,S,H,P)  A: (H,)  h: (B,H,P,N)
    Returns y (B,S,H,P) f32 and h_final (B,H,P,N) f32.  As in the
    reference's kernel route, y is the kernel's output (in x's dtype)
    cast to f32."""
    if impl in _KERNEL:
        Lyr.refuse_grad("ssd_scan kernel", 'impl="plain"', dt, Bc, Cc, x, A,
                        h0)
        y, h = SD.ssd_scan(dt, Bc, Cc, x, A, h0=h0)
    elif impl in _PLAIN:
        y, h = SD.ssd_scan_plain(dt, Bc, Cc, x, A, h0=h0)
    else:
        raise ValueError(f"unknown scan impl {impl!r}")
    return y.float(), h


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _dt_init(u: torch.Tensor) -> torch.Tensor:
    """The reference's dt bias from uniform draws ``u`` in [0, 1): the
    inverse softplus of a dt log-uniform in [1e-3, 1e-1], in f32."""
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return torch.log(torch.expm1(dt))


def init_mamba1(cfg, normal, uniform, dtype, device, lead=()):
    """``normal(*shape, std=)`` / ``uniform(*shape)`` draw normal tensors of
    ``dtype`` / [0, 1) f32 tensors on ``device`` (``transformer.
    init_model``'s generator); every tensor has the leading dims ``lead``
    (``(L,)`` for a stack).  The reference's keys, shapes, stds and
    constants."""
    d, di = cfg.d_model, cfg.d_inner
    s = cfg.ssm
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, s.d_state + 1, **f32))
    return {
        "in_proj": normal(*lead, d, 2 * di),
        "conv_w": normal(*lead, s.d_conv, di, std=0.2),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": normal(*lead, di, s.dt_rank + 2 * s.d_state),
        "dt_proj": normal(*lead, s.dt_rank, di, std=s.dt_rank ** -0.5),
        "dt_bias": _dt_init(uniform(*lead, di)),
        "A_log": a_log.expand(*lead, di, s.d_state).contiguous(),
        "D": torch.ones((*lead, di), **f32),
        "out_proj": normal(*lead, di, d),
    }


def mamba1_in(params, x, cache=None):
    """A mamba1 block up to ``x_proj``: ``(xc, z, new_conv)``, the
    convolved channels after SiLU and the gate's half of ``in_proj``.
    The channels are ``in_proj``'s, ``conv_w``'s: all of ``d_inner``, or a
    tensor-parallel shard's own (``distributed.tp``)."""
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = causal_conv1d(xin, params["conv_w"], params["conv_b"],
                                 conv_state)
    return F.silu(xc), z, new_conv


def mamba1_out(params, dbc, xc, z, h0=None, *, cfg, impl="kernel"):
    """A mamba1 block from ``dbc = xc @ x_proj`` (summed over every
    channel) on: dt, the scan from ``h0``, the skip and the gate, and
    ``out_proj`` over the channels ``xc`` holds.  Returns ``(out, h)``."""
    s = cfg.ssm
    dt, Bc, Cc = torch.split(dbc, [s.dt_rank, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() @ params["dt_proj"].float()
                    + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h = mamba1_scan(dt.to(xc.dtype), Bc, Cc, xc, A, h0=h0, impl=impl)
    y = y.float() + xc.float() * params["D"]
    y = (y * F.silu(z.float())).to(z.dtype)
    return y @ params["out_proj"], h


def mamba1_block(params, x, cache=None, *, cfg, impl="kernel"):
    """x: (B,S,D).  cache: None or {'conv': (B,K-1,Di), 'ssm': (B,Di,N)}.

    Returns (y, new_cache)."""
    xc, z, new_conv = mamba1_in(params, x, cache)
    h0 = cache["ssm"] if cache is not None else None
    out, h = mamba1_out(params, xc @ params["x_proj"], xc, z, h0, cfg=cfg,
                        impl=impl)
    return out, {"conv": new_conv, "ssm": h}


def init_mamba2(cfg, normal, dtype, device, lead=()):
    """As ``init_mamba1``: the reference's keys, shapes, stds and
    constants (``A_log`` = log of H values evenly spaced in [1, 16])."""
    d, di = cfg.d_model, cfg.d_inner
    s = cfg.ssm
    H = di // s.head_dim
    conv_dim = di + 2 * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.from_numpy(
        np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)).to(device)
    return {
        "in_proj": normal(*lead, d, 2 * di + 2 * s.d_state + H),
        "conv_w": normal(*lead, s.d_conv, conv_dim, std=0.2),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "A_log": a_log.expand(*lead, H).contiguous(),
        "D": torch.ones((*lead, H), **f32),
        "norm": torch.ones((*lead, di), dtype=dtype, device=device),
        "out_proj": normal(*lead, di, d),
    }


def mamba2_gated(params, x, cache=None, *, cfg, impl="kernel"):
    """A Mamba-2 block (SSD, n_groups=1) up to its gated RMSNorm:
    ``(y, new_cache)`` with ``y = ssd(x) * silu(z)`` over the heads the
    weights hold (all of them, or a tensor-parallel shard's own, with the
    shared B and C columns: ``distributed.tp``).  cache: {'conv':
    (B,K-1,Di+2N), 'ssm': (B,H,P,N)}."""
    s = cfg.ssm
    di = params["out_proj"].shape[-2]
    H = params["A_log"].shape[-1]
    P, N = s.head_dim, s.d_state
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], params["conv_b"],
                                  conv_state)
    xbc = F.silu(xbc)
    xin, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    B_, S, _ = x.shape
    xh = xin.reshape(B_, S, H, P)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    h0 = cache["ssm"] if cache is not None else None
    y, h = mamba2_scan(dt, Bc, Cc, xh, A, h0=h0, impl=impl)
    y = y + xh.float() * params["D"][:, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    return y * F.silu(z), {"conv": new_conv, "ssm": h}


def mamba2_out(params, y, var):
    """The gated RMSNorm (eps 1e-5) of ``y`` given ``var``, the mean of
    its squares over all of ``d_inner`` (f32, (B, S, 1)), and
    ``out_proj``, as the reference writes them."""
    y = (y * torch.rsqrt(var + 1e-5).to(y.dtype)) * params["norm"]
    return y @ params["out_proj"]


def mamba2_block(params, x, cache=None, *, cfg, impl="kernel"):
    """Mamba-2 (SSD, n_groups=1): ``mamba2_gated``, then ``mamba2_out``
    with the mean of squares over ``d_inner``."""
    y, new_cache = mamba2_gated(params, x, cache, cfg=cfg, impl=impl)
    var = y.float().square().mean(-1, keepdim=True)
    return mamba2_out(params, y, var), new_cache


def ssm_block(cfg, params, x, cache: Optional[dict] = None, *,
              impl="kernel"):
    """The family's mamba block: mamba1 for ``ssm``, mamba2 for
    ``hybrid``."""
    block = mamba1_block if cfg.ssm.kind == "mamba1" else mamba2_block
    return block(params, x, cache, cfg=cfg, impl=impl)
