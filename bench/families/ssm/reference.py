"""The plain reference of the ``ssm`` family, in f32: the whole model over
one sequence, layer by layer, every product in f32 with TF32 off, the
selective scans in f64 (``bench/reference/plain.py``).  It imports nothing
of the program and reads the benchmark's own weights
(``bench/harness/weights.py``) through ``weight``, and the configuration's
``port`` group as a plain dict.

Pre-norm residual layers, ``x + mamba(rms(x))``, as the configuration runs
them (``bench/configs/*.json`` lists each departure from the published
model under ``assumed``):

* ``mamba1`` (falcon-mamba-7b): ``in_proj`` into x and the gate z, a
  depthwise causal conv of width K with bias and SiLU, ``x_proj`` into dt
  (rank R), B and C, ``dt = softplus(dt @ dt_proj + dt_bias)``, the
  selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = h_t
  C_t + D x_t`` gated by ``silu(z)``, then ``out_proj``; ``A =
  -exp(A_log)``.
* ``mamba2``: one group of B and C, a scalar decay a head, the gated
  RMSNorm over ``d_inner`` before ``out_proj``.

Then the final RMSNorm and the LM head; logits for every position.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.families.ssm.work import dims
from bench.reference.plain import as_f32, causal_conv, chunk_bounds, \
    leaf, linear_scan, no_tf32, rms


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


def forward_logits(port: dict, params: dict, tokens: torch.Tensor, *,
                   weight=as_f32, after_layer=None) -> torch.Tensor:
    """Logits (S, V) in f32 of the whole model over ``tokens`` (S,).
    ``weight`` maps each stored weight to the f32 tensor the reference
    multiplies by (the control passes a lower precision's round trip);
    the f32 constants (``dt_bias``, ``A_log``, ``D``) are read as they
    are.  ``after_layer(i, x)``, where given, maps the residual stream
    after layer ``i`` (a family built on this stack adds its blocks
    there)."""
    g = dims(port)
    eps = port.get("norm_eps", 1e-5)
    exact = ("dt_bias", "A_log", "D")

    def layer_weights(i):
        def p(name):
            t = leaf(params["layers"]["mamba"], name)[i]
            return t.float() if name in exact else weight(t)
        return p

    with no_tf32(), torch.no_grad():
        x = weight(params["embed"])[tokens]
        block = mamba1_block if g["kind"] == "mamba1" else mamba2_block
        for i in range(g["L"]):
            h = rms(x, weight(params["layers"]["ln"]["scale"][i]), eps)
            x = x + block(layer_weights(i), h, g)
            if after_layer is not None:
                x = after_layer(i, x)
        x = rms(x, weight(params["final_norm"]["scale"]), eps)
        head = params["embed"].T if port.get("tie_embeddings") \
            else params["lm_head"]
        return x @ weight(head)
