"""The ``dense`` family's weights (a test's third family): a stack of
pre-norm GQA attention + SwiGLU layers with RoPE, the keys, shapes and
``(in, out)`` layout of the port's ``dense`` family
(``repro_torch/models/transformer.py``), layers stacked on a leading L
axis.  Every matrix normal at std ``fan_in ** -0.5`` (0.022 at d_model
2048, about the usual 0.02; at a tiny width the context then moves the
logits as it does at the published one), the embedding and the QKV
biases where the configuration has them at 0.02; norm scales 1."""
from __future__ import annotations

import torch


def leaves(port: dict) -> list:
    d, L, V = port["d_model"], port["num_layers"], port["vocab_size"]
    H, KH, Fd = port["num_heads"], port["num_kv_heads"], port["d_ff"]
    hd = port.get("head_dim") or d // H
    out = [("embed", (V, d), 0.02)]
    if not port.get("tie_embeddings"):
        out.append(("lm_head", (d, V), d ** -0.5))
    out += [("layers/attn/wq", (L, d, H * hd), d ** -0.5),
            ("layers/attn/wk", (L, d, KH * hd), d ** -0.5),
            ("layers/attn/wv", (L, d, KH * hd), d ** -0.5),
            ("layers/attn/wo", (L, H * hd, d), (H * hd) ** -0.5)]
    if port.get("qkv_bias"):
        out += [("layers/attn/bq", (L, H * hd), 0.02),
                ("layers/attn/bk", (L, KH * hd), 0.02),
                ("layers/attn/bv", (L, KH * hd), 0.02)]
    return out + [("layers/mlp/w_gate", (L, d, Fd), d ** -0.5),
                  ("layers/mlp/w_up", (L, d, Fd), d ** -0.5),
                  ("layers/mlp/w_down", (L, Fd, d), Fd ** -0.5)]


def constants(port: dict, tree: dict, gen, dtype, device) -> None:
    d, L = port["d_model"], port["num_layers"]
    ones = dict(dtype=dtype, device=device)
    tree["final_norm"] = {"scale": torch.ones(d, **ones)}
    tree["layers"]["ln1"] = {"scale": torch.ones((L, d), **ones)}
    tree["layers"]["ln2"] = {"scale": torch.ones((L, d), **ones)}
