"""The ``hybrid`` family's weights: the ``ssm`` family's stack, then the
shared attention + SwiGLU block (``shared/``): its matrices normal at std
0.02 after the stack's, its two norm scales 1."""
from __future__ import annotations

import torch

from bench.families.ssm import weights as ssm


def leaves(port: dict) -> list:
    d = port["d_model"]
    hd = port.get("head_dim") or d // port["num_heads"]
    H, KH, Fd = port["num_heads"], port["num_kv_heads"], port["d_ff"]
    return ssm.leaves(port) + [
        ("shared/attn/wq", (d, H * hd), 0.02),
        ("shared/attn/wk", (d, KH * hd), 0.02),
        ("shared/attn/wv", (d, KH * hd), 0.02),
        ("shared/attn/wo", (H * hd, d), 0.02),
        ("shared/mlp/w_gate", (d, Fd), 0.02),
        ("shared/mlp/w_up", (d, Fd), 0.02),
        ("shared/mlp/w_down", (Fd, d), 0.02)]


def constants(port: dict, tree: dict, gen, dtype, device) -> None:
    ssm.constants(port, tree, gen, dtype, device)
    d = port["d_model"]
    sh = tree["shared"]
    sh["ln1"] = {"scale": torch.ones(d, dtype=dtype, device=device)}
    sh["ln2"] = {"scale": torch.ones(d, dtype=dtype, device=device)}
