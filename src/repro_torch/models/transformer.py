"""Decoder models: init, embedding, norm, QKV projection, RoPE tables,
full attention block.

The subset of ``repro/models/transformer.py`` that the stateless and
stateful edge-cloud paths run, for the dense, ssm (stacked mamba1 layers)
and hybrid (stacked mamba2 layers plus one shared attention+MLP layer,
``params["shared"]``) families.  Params are a nested dict of
tensors with the reference's keys, shapes and ``(in, out)`` layout; the
per-layer weights are stacked on a leading L axis
(``params["layers"]["attn"]["wq"]`` is ``(L, d_model, H * head_dim)``), so
a JAX param pytree converts leaf by leaf (``repro_torch.params``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM

_PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port runs "
            f"{_PORTED_FAMILIES}; see ROADMAP.md Queue A)")


def _apply_norm(cfg, p, x):
    return Lyr.rms_norm(x, p["scale"], cfg.norm_eps)


def _project_qkv(cfg, p, h):
    B, S, _ = h.shape
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attn_block_full(cfg, p, x, rope_cs, *, impl, causal=True, window=None,
                    q_offset=0):
    """Self-attention + MLP sublayers over a full sequence.
    Returns (x, (k, v), aux) with k/v sequence-major (B, S, KH, hd)."""
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(cfg, p["attn"], h)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = Lyr.apply_rope(q, cos, sin)
        k = Lyr.apply_rope(k, cos, sin)
    att = Lyr.attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, impl=impl)
    B, S = x.shape[:2]
    x = x + att.reshape(B, S, -1) @ p["attn"]["wo"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h2 = _apply_norm(cfg, p["ln2"], x)
    x = x + Lyr.mlp(p["mlp"], h2, gated=cfg.gated_mlp)
    return x, (k, v), aux


def embed_inputs(cfg, params, inputs):
    """Token embedding (the ported families have no frontend): (B, S, D)."""
    return params["embed"][inputs["tokens"]]


def lm_head_weights(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _rope_for(cfg, S, offset=0, device=None):
    """RoPE tables of positions ``offset .. offset + S - 1``."""
    pos = offset + torch.arange(S, device=device)
    return Lyr.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _decoder_layer(cfg, normal, ones, zeros, lead=()):
    """One attention decoder layer's weights (``init_decoder_layer``),
    each with the leading dims ``lead`` (``(L,)`` for a stack)."""
    d, hd, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    H, KH = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": normal(*lead, d, H * hd), "wk": normal(*lead, d, KH * hd),
            "wv": normal(*lead, d, KH * hd), "wo": normal(*lead, H * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(*lead, H * hd), bk=zeros(*lead, KH * hd),
                    bv=zeros(*lead, KH * hd))
    if cfg.gated_mlp:
        mlp = {"w_gate": normal(*lead, d, F), "w_up": normal(*lead, d, F),
               "w_down": normal(*lead, F, d)}
    else:
        mlp = {"w_up": normal(*lead, d, F), "w_down": normal(*lead, F, d)}
    return {"ln1": {"scale": ones(*lead, d)}, "attn": attn,
            "ln2": {"scale": ones(*lead, d)}, "mlp": mlp}


def init_model(cfg, generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32, device="cuda", *,
               seed: int = 0) -> Dict[str, Any]:
    """Random weights with the reference's keys, shapes, layout, dtypes and
    std (``repro.models.transformer.init_model``): normal * 0.02 for every
    attention/MLP matrix, ones for norm scales, zeros for QKV biases, and
    ``models.ssm``'s initialisation of the mamba blocks (their ``dt_bias``,
    ``A_log`` and ``D`` in f32 whatever ``dtype``).  The ``ssm`` family
    stacks mamba1 layers; ``hybrid`` stacks mamba2 layers and adds
    ``params["shared"]``, one attention decoder layer.

    ``generator`` draws every tensor in a fixed order; without one, a
    generator on ``device`` seeded with ``seed`` is made.  The numbers
    differ from JAX's for the same seed (another generator): tests that
    compare the packages convert one set of weights with
    ``repro_torch.params`` instead."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.d_model, cfg.num_layers

    def normal(*shape, std=0.02):
        t = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return t.mul_(std)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params: Dict[str, Any] = {"embed": normal(cfg.vocab_size, d),
                              "final_norm": {"scale": ones(d)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, cfg.vocab_size)
    if cfg.family == "dense":
        params["layers"] = _decoder_layer(cfg, normal, ones, zeros, (L,))
        return params
    if cfg.ssm.kind == "mamba1":
        mamba = SSM.init_mamba1(cfg, normal, uniform, dtype, dev, (L,))
    else:
        mamba = SSM.init_mamba2(cfg, normal, dtype, dev, (L,))
    params["layers"] = {"ln": {"scale": ones(L, d)}, "mamba": mamba}
    if cfg.family == "hybrid":
        params["shared"] = _decoder_layer(cfg, normal, ones, zeros)
    return params
