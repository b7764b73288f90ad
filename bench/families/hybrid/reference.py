"""The plain reference of the ``hybrid`` family (zamba2-7b), in f32: the
``ssm`` family's reference with, after every ``hybrid_period``-th layer,
one shared pre-norm attention + SwiGLU MLP block (RoPE on q and k, causal
softmax attention, heads of ``d_model / num_heads``).  It imports nothing
of the program."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.families.hybrid.work import dims
from bench.families.ssm import reference as ssm
from bench.reference.plain import as_f32, causal_attention, leaf, rms, rope


def shared_block(p, x, g, eps, theta, q_rows=1024):
    S = x.shape[0]
    H, KH, hd = g["AH"], g["AKH"], g["hd"]
    h = rms(x, p("ln1/scale"), eps)
    q = rope((h @ p("attn/wq")).reshape(S, H, hd), theta)
    k = rope((h @ p("attn/wk")).reshape(S, KH, hd), theta)
    v = (h @ p("attn/wv")).reshape(S, KH, hd)
    out = causal_attention(q, k, v, q_rows)
    x = x + out.reshape(S, H * hd) @ p("attn/wo")
    h = rms(x, p("ln2/scale"), eps)
    return x + (F.silu(h @ p("mlp/w_gate")) * (h @ p("mlp/w_up"))) \
        @ p("mlp/w_down")


def forward_logits(port: dict, params: dict, tokens: torch.Tensor, *,
                   weight=as_f32) -> torch.Tensor:
    """Logits (S, V) in f32 of the whole model over ``tokens`` (S,);
    ``weight`` as the ``ssm`` family's."""
    g = dims(port)
    eps = port.get("norm_eps", 1e-5)
    theta = port.get("rope_theta", 10_000.0)

    def shared(name):
        return weight(leaf(params["shared"], name))

    def after_layer(i, x):
        if (i + 1) % g["period"] == 0:
            return shared_block(shared, x, g, eps, theta)
        return x

    return ssm.forward_logits(port, params, tokens, weight=weight,
                              after_layer=after_layer)
