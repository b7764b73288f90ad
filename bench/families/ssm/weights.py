"""The ``ssm`` family's weights: a stack of Mamba-1 or Mamba-2 layers
(``ssm.kind``), the keys, shapes and ``(in, out)`` layout the port's stage
runners read (``repro_torch/models/transformer.py``), layers stacked on a
leading L axis.

* ``leaves(port)``: every normal leaf ``(path, shape, std)`` in draw
  order: the embedding, the LM head and every matrix at std 0.02,
  ``conv_w`` 0.2, mamba1's ``dt_proj`` ``dt_rank ** -0.5``;
* ``constants(port, tree, gen, dtype, device)``: the rest, into ``tree``:
  mamba1's ``dt_bias`` the inverse softplus of a dt log-uniform in [1e-3,
  1e-1] (drawn from ``gen`` after the normal leaves), ``A_log = log(1..N)``;
  mamba2's ``A_log`` the log of H values evenly spaced in [1, 16],
  ``dt_bias`` 0; ``dt_bias``, ``A_log`` and ``D`` in f32; ``D`` and norm
  scales 1, conv biases 0.
"""
from __future__ import annotations

import math

import torch


def leaves(port: dict) -> list:
    s = port["ssm"]
    d, L, V = port["d_model"], port["num_layers"], port["vocab_size"]
    di = s.get("expand", 2) * d
    K, N = s.get("d_conv", 4), s["d_state"]
    out = [("embed", (V, d), 0.02)]
    if not port.get("tie_embeddings"):
        out.append(("lm_head", (d, V), 0.02))
    m = "layers/mamba/"
    if s["kind"] == "mamba1":
        R = s.get("dt_rank") or -(-d // 16)
        out += [(m + "in_proj", (L, d, 2 * di), 0.02),
                (m + "conv_w", (L, K, di), 0.2),
                (m + "x_proj", (L, di, R + 2 * N), 0.02),
                (m + "dt_proj", (L, R, di), R ** -0.5),
                (m + "out_proj", (L, di, d), 0.02)]
    else:
        H = di // s.get("head_dim", 64)
        out += [(m + "in_proj", (L, d, 2 * di + 2 * N + H), 0.02),
                (m + "conv_w", (L, K, di + 2 * N), 0.2),
                (m + "out_proj", (L, di, d), 0.02)]
    return out


def constants(port: dict, tree: dict, gen, dtype, device) -> None:
    s = port["ssm"]
    d, L = port["d_model"], port["num_layers"]
    di = s.get("expand", 2) * d
    N = s["d_state"]
    f32 = dict(dtype=torch.float32, device=device)
    ones = dict(dtype=dtype, device=device)
    tree["final_norm"] = {"scale": torch.ones(d, **ones)}
    tree["layers"]["ln"] = {"scale": torch.ones((L, d), **ones)}
    m = tree["layers"]["mamba"]
    if s["kind"] == "mamba1":
        u = torch.rand((L, di), generator=gen, **f32)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        m["dt_bias"] = torch.log(torch.expm1(dt))
        m["A_log"] = torch.log(torch.arange(1, N + 1, **f32)).expand(
            L, di, N).contiguous()
        m["D"] = torch.ones((L, di), **f32)
        m["conv_b"] = torch.zeros((L, di), **ones)
    else:
        H = di // s.get("head_dim", 64)
        m["dt_bias"] = torch.zeros((L, H), **f32)
        m["A_log"] = torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(
            L, H).contiguous()
        m["D"] = torch.ones((L, H), **f32)
        m["conv_b"] = torch.zeros((L, di + 2 * N), **ones)
        m["norm"] = torch.ones((L, di), **ones)
