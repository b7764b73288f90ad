"""The benchmark's weights, made from the seed on the device.

The tree has the keys, shapes, ``(in, out)`` layout and dtypes the port's
stage runners read (``repro_torch/models/transformer.py`` documents them):
layers stacked on a leading L axis, the mamba blocks' ``dt_bias``,
``A_log`` and ``D`` in f32, everything else in the served dtype.  The
values are the benchmark's own, so the reference (``bench/reference``)
reads the same weights and nothing the program made:

* every matrix, the embedding and the LM head: normal with std 0.02
  (``conv_w`` 0.2, mamba1's ``dt_proj`` ``dt_rank ** -0.5``), drawn in ONE
  call into one buffer of the served dtype and carved into views;
* mamba1's ``dt_bias``: the inverse softplus of a dt log-uniform in
  [1e-3, 1e-1]; ``A_log = log(1..N)``; mamba2's ``A_log`` the log of H
  values evenly spaced in [1, 16], ``dt_bias`` 0; ``D``, norm scales 1,
  conv biases 0.
"""
from __future__ import annotations

import math

import torch


def _normal_leaves(port: dict) -> list:
    """``(path, shape, std)`` of every normal leaf, in draw order."""
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
    if port.get("hybrid_period"):
        hd = port.get("head_dim") or d // port["num_heads"]
        H, KH, Fd = port["num_heads"], port["num_kv_heads"], port["d_ff"]
        out += [("shared/attn/wq", (d, H * hd), 0.02),
                ("shared/attn/wk", (d, KH * hd), 0.02),
                ("shared/attn/wv", (d, KH * hd), 0.02),
                ("shared/attn/wo", (H * hd, d), 0.02),
                ("shared/mlp/w_gate", (d, Fd), 0.02),
                ("shared/mlp/w_up", (d, Fd), 0.02),
                ("shared/mlp/w_down", (Fd, d), 0.02)]
    return out


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def make_weights(port: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weight tree of ``port`` drawn from ``seed`` on ``device``."""
    s = port["ssm"]
    d, L = port["d_model"], port["num_layers"]
    di = s.get("expand", 2) * d
    K, N = s.get("d_conv", 4), s["d_state"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = _normal_leaves(port)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    off = 0
    for path, shape, std in leaves:
        n = math.prod(shape)
        _put(tree, path, flat[off:off + n].view(shape).mul_(std))
        off += n
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
    if port.get("hybrid_period"):
        sh = tree["shared"]
        sh["ln1"] = {"scale": torch.ones(d, **ones)}
        sh["ln2"] = {"scale": torch.ones(d, **ones)}
    return tree

