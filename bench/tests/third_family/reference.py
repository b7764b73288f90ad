"""The plain reference of the ``dense`` family (a test's third family), in
f32 with TF32 off: pre-norm residual layers, ``x + attn(rms(x))`` (q, k
and v with their biases where the configuration has them, RoPE on q and
k, causal softmax attention, each KV head serving ``H / KH`` query
heads), then ``x + swiglu(rms(x))``; the final RMSNorm and the LM head.
It imports nothing of the program."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.plain import as_f32, causal_attention, leaf, \
    no_tf32, rms, rope


def forward_logits(port: dict, params: dict, tokens: torch.Tensor, *,
                   weight=as_f32) -> torch.Tensor:
    """Logits (S, V) in f32 of the whole model over ``tokens`` (S,).
    ``weight`` maps each stored weight to the f32 tensor the reference
    multiplies by."""
    d, H, KH = port["d_model"], port["num_heads"], port["num_kv_heads"]
    hd = port.get("head_dim") or d // H
    eps = port.get("norm_eps", 1e-5)
    theta = port.get("rope_theta", 10_000.0)
    S = tokens.shape[0]

    def proj(p, h, name, heads):
        y = h @ p(f"attn/w{name}")
        if port.get("qkv_bias"):
            y = y + p(f"attn/b{name}")
        return y.reshape(S, heads, hd)

    def layer_weights(i):
        def p(name):
            return weight(leaf(params["layers"], name)[i])
        return p

    with no_tf32(), torch.no_grad():
        x = weight(params["embed"])[tokens]
        for i in range(port["num_layers"]):
            p = layer_weights(i)
            h = rms(x, p("ln1/scale"), eps)
            q = rope(proj(p, h, "q", H), theta)
            k = rope(proj(p, h, "k", KH), theta)
            v = proj(p, h, "v", KH)
            out = causal_attention(q, k, v)
            x = x + out.reshape(S, H * hd) @ p("attn/wo")
            h = rms(x, p("ln2/scale"), eps)
            x = x + (F.silu(h @ p("mlp/w_gate")) * (h @ p("mlp/w_up"))) \
                @ p("mlp/w_down")
        x = rms(x, weight(params["final_norm"]["scale"]), eps)
        head = params["embed"].T if port.get("tie_embeddings") \
            else params["lm_head"]
        return x @ weight(head)
