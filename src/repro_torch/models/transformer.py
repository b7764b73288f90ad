"""Decoder models: init, the full-sequence blocks, and the standalone
entry points ``forward_hidden``, ``prefill`` and ``decode_step``.

The PyTorch counterpart of ``repro/models/transformer.py`` for every
family: dense, moe (attention + ``layers.moe_layer``), vlm (dense layers
behind stub patch embeddings projected by ``vision_proj`` and prepended to
the text), ssm (stacked mamba1 layers), hybrid (stacked mamba2 layers plus
one shared attention+MLP layer, ``params["shared"]``) and audio (whisper:
a bidirectional encoder over stub frame embeddings, ``params["encoder"]``,
and decoder layers with self and cross attention, LayerNorms with bias and
sinusoidal absolute positions in place of RoPE).  ``train_loss`` is the
full-sequence forward and the chunked cross entropy a training step
differentiates.  Params are a nested dict of
tensors with the reference's keys, shapes and ``(in, out)`` layout; the
per-layer weights are stacked on a leading L axis
(``params["layers"]["attn"]["wq"]`` is ``(L, d_model, H * head_dim)``), so
a JAX param pytree converts leaf by leaf (``repro_torch.params``).

Where the port differs from the reference, and why:

* **Eager layers.**  The reference scans (``lax.scan``) over the stacked
  layers to keep its compiled program depth-independent; here each entry
  point is one Python loop over the layers.  ``remat`` wraps each layer
  body (and each encoder layer) in ``torch.utils.checkpoint`` where the
  reference wraps it in ``jax.checkpoint``, when autograd records a
  gradient of the weights; a forward without one runs the bodies as they
  are.
* **In-place decode caches.**  ``decode_step`` writes the token's K/V
  into the cache's stacked tensors in place (one row, at the ring index)
  and returns a new dict holding the same K/V tensors and ``pos + 1``;
  the reference returns updated copies.  A caller that needs the cache
  from before a step clones it.
* **The ring.**  A windowed cache holds ``CL = min(max_seq, window)`` rows
  and position ``p`` lives at row ``p mod CL`` (``_cache_from_prefill``
  places a prompt longer than ``CL`` that way too), so ``decode_step``
  after ``prefill`` equals the windowed forward over the longer sequence
  at every prompt length.  The reference keeps such a prompt's last
  ``CL`` rows at rows ``0 .. CL - 1``, which agrees only when
  ``S mod CL == 0`` (ROADMAP.md, Queue C).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_decode as FD
from repro_torch.models import layers as Lyr
from repro_torch.models import ssm as SSM

_ATTN_FAMILIES = ("dense", "moe", "vlm")
_PORTED_FAMILIES = _ATTN_FAMILIES + ("ssm", "hybrid", "audio")


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise ValueError(cfg.family)


def _apply_norm(cfg, p, x):
    if cfg.family == "audio":
        return Lyr.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return Lyr.rms_norm(x, p["scale"], cfg.norm_eps)


def _project_qkv(cfg, p, h):
    B, S, _ = h.shape
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # heads from the weights' widths: a tensor-parallel shard holds some
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    return q, k, v


def feed_forward(cfg, p, h):
    """The layer's MLP, or its MoE where it has one (routed with the
    config's ``top_k`` and ``capacity_factor``): ``(y, aux)``, aux the
    MoE's load-balance loss or None."""
    if "moe" in p:
        m = cfg.moe
        return Lyr.moe_layer(p["moe"], h, top_k=m.top_k,
                             capacity_factor=m.capacity_factor,
                             aux_coef=m.router_aux_coef)
    return Lyr.mlp(p["mlp"], h, gated=cfg.gated_mlp), None


def attn_out_full(cfg, p, x, rope_cs, *, impl, causal=True, window=None,
                  q_offset=0):
    """The self-attention sublayer over a full sequence, up to its
    residual add: ``(att @ wo, (k, v))``, k/v sequence-major (B, S, KH,
    hd)."""
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(cfg, p["attn"], h)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = Lyr.apply_rope(q, cos, sin)
        k = Lyr.apply_rope(k, cos, sin)
    att = Lyr.attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, impl=impl)
    B, S = x.shape[:2]
    return att.reshape(B, S, -1) @ p["attn"]["wo"], (k, v)


def attn_block_full(cfg, p, x, rope_cs, *, impl, causal=True, window=None,
                    q_offset=0):
    """Self-attention + MLP (or MoE) sublayers over a full sequence.
    Returns (x, (k, v), aux) with k/v sequence-major (B, S, KH, hd) and
    aux the MoE's load-balance loss (0 without one)."""
    y, (k, v) = attn_out_full(cfg, p, x, rope_cs, impl=impl, causal=causal,
                              window=window, q_offset=q_offset)
    x = x + y
    h2 = _apply_norm(cfg, p["ln2"], x)
    ff, aux = feed_forward(cfg, p, h2)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff, (k, v), aux


def cross_out_full(cfg, p, x, enc_kv, *, impl):
    """Whisper's cross-attention sublayer up to its residual add: the
    normed hidden's queries against the encoder's ``enc_kv``, non-causal,
    times ``wo`` (the heads the weights hold)."""
    h = _apply_norm(cfg, p["ln_x"], x)
    B, S, _ = h.shape
    q = (h @ p["xattn"]["wq"]).reshape(B, S, -1, cfg.head_dim)
    ck, cv = enc_kv
    att = Lyr.attention(q, ck, cv, causal=False, impl=impl)
    return att.reshape(B, S, -1) @ p["xattn"]["wo"]


def cross_block_full(cfg, p, x, enc_kv, *, impl):
    """Cross-attention sublayer (whisper's decoder) with its residual."""
    return x + cross_out_full(cfg, p, x, enc_kv, impl=impl)


def _enc_cross_kv(cfg, p, enc_out):
    """K/V of the encoder output under a decoder layer's cross-attention
    weights, sequence-major ``(B, T_enc, KH, hd)`` (KH: the heads the
    weights hold)."""
    B, S, _ = enc_out.shape
    ck = (enc_out @ p["xattn"]["wk"]).reshape(B, S, -1, cfg.head_dim)
    cv = (enc_out @ p["xattn"]["wv"]).reshape(B, S, -1, cfg.head_dim)
    return ck, cv


def embed_inputs(cfg, params, inputs):
    """Token embedding, after the projected patch embeddings for the
    vision frontend: (B, frontend_tokens + S, D)."""
    x = params["embed"][inputs["tokens"]]
    if cfg.frontend == "vision":
        vis = inputs["vision_embeds"] @ params["vision_proj"]
        x = torch.cat([vis.to(x.dtype), x], dim=1)
    return x


def text_positions(cfg, S: int, device=None):
    """Whisper's decoder positions (``sinusoidal_positions``) as an f32
    ``(1, S, d_model)`` table, added to the token embedding."""
    return Lyr.sinusoidal_positions(S, cfg.d_model, device=device)[None]


def lm_head_weights(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _rope_for(cfg, S, offset=0, device=None):
    """RoPE tables of positions ``offset .. offset + S - 1``; None for
    whisper, whose positions are sinusoidal and absolute."""
    if cfg.family == "audio":
        return None
    pos = offset + torch.arange(S, device=device)
    return Lyr.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_moe_params(cfg, normal, lead=()):
    """One MoE sublayer's weights (``init_moe_params``): the router (D, E)
    in f32 whatever the model's dtype, the routed experts stacked (E, D, F)
    / (E, F, D), and the shared experts' SiLU-gated MLP where the config
    has them; each with the leading dims ``lead``."""
    m = cfg.moe
    d, E, F = cfg.d_model, m.num_experts, m.expert_d_ff
    p = {"router": normal(*lead, d, E, dtype=torch.float32),
         "w_gate": normal(*lead, E, d, F), "w_up": normal(*lead, E, d, F),
         "w_down": normal(*lead, E, F, d)}
    if m.num_shared_experts:
        p.update(shared_w_gate=normal(*lead, d, m.shared_d_ff),
                 shared_w_up=normal(*lead, d, m.shared_d_ff),
                 shared_w_down=normal(*lead, m.shared_d_ff, d))
    return p


def _norm_params(cfg, ones, zeros, lead=()):
    """A norm's weights: a scale, and for whisper's LayerNorm a bias."""
    p = {"scale": ones(*lead, cfg.d_model)}
    if cfg.family == "audio":
        p["bias"] = zeros(*lead, cfg.d_model)
    return p


def _attn_params(cfg, normal, zeros, lead=()):
    d, hd = cfg.d_model, cfg.head_dim
    H, KH = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": normal(*lead, d, H * hd), "wk": normal(*lead, d, KH * hd),
            "wv": normal(*lead, d, KH * hd), "wo": normal(*lead, H * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(*lead, H * hd), bk=zeros(*lead, KH * hd),
                    bv=zeros(*lead, KH * hd))
    return attn


def _decoder_layer(cfg, normal, ones, zeros, lead=(), *, cross=False):
    """One attention decoder layer's weights (``init_decoder_layer``),
    each with the leading dims ``lead`` (``(L,)`` for a stack): an MoE
    sublayer (``"moe"``) in place of the MLP where the config has one,
    and with ``cross`` whisper's cross attention (``"ln_x"``,
    ``"xattn"``)."""
    d, F = cfg.d_model, cfg.d_ff
    layer = {"ln1": _norm_params(cfg, ones, zeros, lead),
             "attn": _attn_params(cfg, normal, zeros, lead),
             "ln2": _norm_params(cfg, ones, zeros, lead)}
    if cfg.moe is not None:
        layer["moe"] = init_moe_params(cfg, normal, lead)
    elif cfg.gated_mlp:
        layer["mlp"] = {"w_gate": normal(*lead, d, F),
                        "w_up": normal(*lead, d, F),
                        "w_down": normal(*lead, F, d)}
    else:
        layer["mlp"] = {"w_up": normal(*lead, d, F),
                        "w_down": normal(*lead, F, d)}
    if cross:
        layer["ln_x"] = _norm_params(cfg, ones, zeros, lead)
        layer["xattn"] = _attn_params(cfg, normal, zeros, lead)
    return layer


def init_model(cfg, generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32, device="cuda", *,
               seed: int = 0) -> Dict[str, Any]:
    """Random weights with the reference's keys, shapes, layout, dtypes and
    std (``repro.models.transformer.init_model``): normal * 0.02 for every
    attention/MLP matrix, ones for norm scales, zeros for QKV biases, and
    ``models.ssm``'s initialisation of the mamba blocks (their ``dt_bias``,
    ``A_log`` and ``D`` in f32 whatever ``dtype``, as the MoE router).
    The ``dense``, ``moe`` and ``vlm`` families stack attention decoder
    layers (``moe`` with an MoE sublayer in place of the MLP); the ``ssm``
    family stacks mamba1 layers; ``hybrid`` stacks mamba2 layers and adds
    ``params["shared"]``, one attention decoder layer; ``audio`` stacks
    decoder layers with cross attention and adds ``params["encoder"]``
    (``"layers"``, ``"final_norm"``).  The vision frontend adds
    ``params["vision_proj"]`` ``(d_model, d_model)``.

    ``generator`` draws every tensor in a fixed order; without one, a
    generator on ``device`` seeded with ``seed`` is made.  The numbers
    differ from JAX's for the same seed (another generator): tests that
    compare the packages convert one set of weights with
    ``repro_torch.params`` instead.  On ``device="meta"`` the tree has the
    same shapes and dtypes and no storage, and nothing is drawn (the
    counterpart of ``jax.eval_shape(init_model)``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    meta = dev.type == "meta"
    if generator is None and not meta:
        generator = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.d_model, cfg.num_layers

    def normal(*shape, std=0.02, dtype=dtype):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        t = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return t.mul_(std)

    def uniform(*shape):
        if meta:
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params: Dict[str, Any] = {"embed": normal(cfg.vocab_size, d),
                              "final_norm": _norm_params(cfg, ones, zeros)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, cfg.vocab_size)
    if cfg.frontend == "vision":
        params["vision_proj"] = normal(d, d)
    if cfg.family in _ATTN_FAMILIES:
        params["layers"] = _decoder_layer(cfg, normal, ones, zeros, (L,))
        return params
    if cfg.family == "audio":
        params["layers"] = _decoder_layer(cfg, normal, ones, zeros, (L,),
                                          cross=True)
        params["encoder"] = {
            "layers": _decoder_layer(cfg, normal, ones, zeros,
                                     (cfg.encoder.num_layers,)),
            "final_norm": _norm_params(cfg, ones, zeros)}
        return params
    if cfg.ssm.kind == "mamba1":
        mamba = SSM.init_mamba1(cfg, normal, uniform, dtype, dev, (L,))
    else:
        mamba = SSM.init_mamba2(cfg, normal, dtype, dev, (L,))
    params["layers"] = {"ln": {"scale": ones(L, d)}, "mamba": mamba}
    if cfg.family == "hybrid":
        params["shared"] = _decoder_layer(cfg, normal, ones, zeros)
    return params


# ---------------------------------------------------------------------------
# full-sequence forward (train and prefill)
# ---------------------------------------------------------------------------

def layer_params(params, idx: int):
    """Layer ``idx``'s weights as views into the stacked tensors."""
    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[idx]
    return walk(params["layers"])


def unstack_layers(stack, n: int) -> list:
    """A stack of ``n`` layers' weights (leaves with a leading L axis) as
    ``n`` dicts of views, split once by ``torch.unbind``: a gradient
    through them is stacked once per leaf, where indexing each layer
    (``layer_params``) would add a zero tensor of the whole stack per
    layer."""
    if isinstance(stack, dict):
        parts = {k: unstack_layers(v, n) for k, v in stack.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(stack, 0))


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    return tree.requires_grad


def _remat(fn, remat: bool, params):
    """``fn`` under activation checkpointing (the reference's
    ``jax.checkpoint``) where ``remat`` asks for it and autograd records a
    gradient of ``params``; ``fn`` itself otherwise."""
    if not (remat and torch.is_grad_enabled() and _needs_grad(params)):
        return fn

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def encode_audio(cfg, params, frames, *, attn_impl="chunked", remat=True):
    """Whisper's encoder over stub frame embeddings ``(B, T_enc, D)``:
    sinusoidal positions added in ``frames``' dtype, every encoder layer
    non-causal (each checkpointed under ``remat``), then the encoder's
    final norm."""
    x = frames + Lyr.sinusoidal_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(
            frames.dtype)[None]
    enc = params["encoder"]

    def body(lp, x):
        return attn_block_full(cfg, lp, x, None, impl=attn_impl,
                               causal=False)[0]
    body = _remat(body, remat, enc)
    for lp in unstack_layers(enc["layers"], cfg.encoder.num_layers):
        x = body(lp, x)
    return _apply_norm(cfg, enc["final_norm"], x)


def forward_hidden(cfg, params, inputs, *, attn_impl="chunked", window=None,
                   remat=True, collect_kv=False, ssm_impl="kernel"):
    """Embedding, every decoder layer and the final norm.

    Returns ``(hidden (B, S, D), aux_loss, kv_tree or None)``, S counting
    the vision frontend's rows; with ``collect_kv`` the tree is, for
    ``dense``/``moe``/``vlm``, ``{"k", "v"}`` each ``(L, B, S, KH, hd)``;
    for ``audio`` also the cross K/V ``{"ck", "cv"}`` each ``(L, B, T_enc,
    KH, hd)``; for ``ssm`` the mamba layers' final state ``{"conv",
    "ssm"}`` stacked on L; for ``hybrid`` ``{"mamba": ..., "attn": {"k",
    "v"}}`` with one KV per shared-block application.
    ``attn_impl``: ``layers.attention``'s (``"kernel"``/``"pallas"`` for
    the flash-attention kernel); ``ssm_impl``: the scans' (``models.ssm``,
    the kernels by default).  ``remat`` checkpoints each layer body when a
    gradient is recorded (module docstring); the hybrid's shared block
    runs unwrapped, as in the reference."""
    _check_family(cfg)
    x = embed_inputs(cfg, params, inputs)
    B, S, _ = x.shape
    rope_cs = _rope_for(cfg, S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    L = cfg.num_layers
    kv_tree = None
    if cfg.family == "audio":
        x = x + text_positions(cfg, S, x.device).to(x.dtype)

    def attn_body(p, x):
        return attn_block_full(cfg, p, x, rope_cs, impl=attn_impl,
                               window=window)
    attn = _remat(attn_body, remat, params)

    def stacked(kvs):
        return {"k": torch.stack([k for k, _ in kvs]),
                "v": torch.stack([v for _, v in kvs])}

    kvs, caches = [], []
    layers = unstack_layers(params["layers"], L)
    if cfg.family in _ATTN_FAMILIES:
        for lp in layers:
            x, kv, a = attn(lp, x)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
        if collect_kv:
            kv_tree = stacked(kvs)
    elif cfg.family == "audio":
        enc_out = encode_audio(cfg, params, inputs["frames"],
                               attn_impl=attn_impl, remat=remat)

        def dec_body(lp, x, enc_out):
            x, kv, a = attn_body(lp, x)
            ckv = _enc_cross_kv(cfg, lp, enc_out)
            x = cross_block_full(cfg, lp, x, ckv, impl=attn_impl)
            return x, a, kv, ckv
        dec = _remat(dec_body, remat, params)
        ckvs = []
        for lp in layers:
            x, a, kv, ckv = dec(lp, x, enc_out)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
                ckvs.append(ckv)
        if collect_kv:
            kv_tree = dict(stacked(kvs),
                           ck=torch.stack([k for k, _ in ckvs]),
                           cv=torch.stack([v for _, v in ckvs]))
    else:
        period = cfg.hybrid_period if cfg.family == "hybrid" else 0

        def ssm_body(lp, x):
            y, cache = SSM.ssm_block(cfg, lp["mamba"],
                                     _apply_norm(cfg, lp["ln"], x),
                                     impl=ssm_impl)
            return x + y, cache
        ssm = _remat(ssm_body, remat, params)
        for li, lp in enumerate(layers):
            x, cache = ssm(lp, x)
            if collect_kv:
                caches.append(cache)
            if period and (li + 1) % period == 0:
                x, kv, a = attn_body(params["shared"], x)
                aux = aux + a
                if collect_kv:
                    kvs.append(kv)
        if collect_kv:
            kv_tree = {"conv": torch.stack([c["conv"] for c in caches]),
                       "ssm": torch.stack([c["ssm"] for c in caches])}
            if period:
                kv_tree = {"mamba": kv_tree, "attn": stacked(kvs)}
    x = _apply_norm(cfg, params["final_norm"], x)
    return x, aux, kv_tree


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def chunked_cross_entropy(cfg, params, hidden, labels, chunk=512):
    """Next-token cross entropy without materialising (B, S, V) logits:
    ``chunk`` rows of logits at a time, in f32.

    hidden: (B, S, D); labels: (B, S) int, -1 = ignore.  The mean over
    the labelled rows (over at least one)."""
    w = lm_head_weights(cfg, params)
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    hp = F.pad(hidden, (0, 0, 0, nc * chunk - S))
    lp = F.pad(labels, (0, nc * chunk - S), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        h = hp[:, c * chunk:(c + 1) * chunk]
        lab = lp[:, c * chunk:(c + 1) * chunk]
        logits = (h @ w).float()                             # (B, c, V)
        logz = torch.logsumexp(logits, -1)
        tgt = logits.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0]
        valid = (lab >= 0).float()
        tot = tot + ((logz - tgt) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp_min(1.0)


def train_loss(cfg, params, batch, *, attn_impl="chunked", remat=True):
    """batch: ``{"tokens", "labels", [frontend inputs]}`` -> ``(loss,
    {"ce", "aux"})``: the full-sequence forward under the config's window,
    then ``chunked_cross_entropy`` (the vision rows labelled -1) plus the
    MoE's load-balance loss.  The SSM scans run their plain route, the
    reference's ``jnp`` scan: a kernel has no backward."""
    hidden, aux, _ = forward_hidden(cfg, params, batch, attn_impl=attn_impl,
                                    window=cfg.sliding_window, remat=remat,
                                    ssm_impl="plain")
    labels = batch["labels"]
    if cfg.frontend == "vision":
        nf = batch["vision_embeds"].shape[1]
        ignore = labels.new_full((labels.shape[0], nf), -1)
        labels = torch.cat([ignore, labels], dim=1)
    ce = chunked_cross_entropy(cfg, params, hidden, labels)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg, params, inputs, *, max_seq, attn_impl="chunked", window=None,
            remat=True, ssm_impl="kernel"):
    """Full-prompt forward.  Returns ``(last_logits (B, V) f32, cache)``,
    the cache as ``init_cache`` shapes it, ``pos`` the prompt length (the
    vision frontend's rows included).
    ``window`` defaults to the config's native sliding window."""
    window = window if window is not None else cfg.sliding_window
    hidden, _, kv = forward_hidden(cfg, params, inputs, attn_impl=attn_impl,
                                   window=window, remat=remat,
                                   collect_kv=True, ssm_impl=ssm_impl)
    S = hidden.shape[1]
    logits = (hidden[:, -1] @ lm_head_weights(cfg, params)).float()
    return logits, _cache_from_prefill(cfg, kv, S, max_seq, window)


def ring_rows(a, cache_len: int):
    """Sequence-major K/V ``(L, B, S, KH, hd)`` of positions ``0 .. S-1``
    as a heads-major ring ``(L, B, KH, cache_len, hd)``: position ``p`` at
    row ``p mod cache_len`` (the last ``cache_len`` positions where ``S``
    exceeds it), zeros in rows no position reached."""
    S = a.shape[2]
    if S >= cache_len:
        a = torch.roll(a[:, :, S - cache_len:], shifts=S % cache_len, dims=2)
    else:
        a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, cache_len - S))
    return a.transpose(2, 3).contiguous()


def _cache_from_prefill(cfg, kv, S, max_seq, window):
    pos = torch.tensor(S, dtype=torch.int32, device=_kv_device(kv))
    cl = _cache_len(cfg, max_seq, window)
    if cfg.family in _ATTN_FAMILIES:
        return {"k": ring_rows(kv["k"], cl), "v": ring_rows(kv["v"], cl),
                "pos": pos}
    if cfg.family == "audio":
        # the cross K/V heads-major, every encoder row (no ring)
        return {"k": ring_rows(kv["k"], cl), "v": ring_rows(kv["v"], cl),
                "ck": kv["ck"].transpose(2, 3).contiguous(),
                "cv": kv["cv"].transpose(2, 3).contiguous(), "pos": pos}
    if cfg.family == "ssm":
        return {"mamba": kv, "pos": pos}
    return {"mamba": kv["mamba"],
            "attn": {"k": ring_rows(kv["attn"]["k"], cl),
                     "v": ring_rows(kv["attn"]["v"], cl)},
            "pos": pos}


def _kv_device(kv):
    while isinstance(kv, dict):
        kv = next(iter(kv.values()))
    return kv.device


def _cache_len(cfg, max_seq, window):
    return min(max_seq, window) if window else max_seq


def effective_window(cfg, seq_len):
    """Attention window used at this sequence length (swa-variant policy)."""
    if cfg.sliding_window:
        return cfg.sliding_window
    if cfg.long_context_window and seq_len > 131_072:
        return cfg.long_context_window
    return None


def init_cache(cfg, batch, max_seq, dtype=torch.float32, window=None,
               device="cuda"):
    """Zero decode cache (shapes mirror ``_cache_from_prefill``): K/V
    heads-major ``(L, B, KH, CL, hd)`` with ``CL = min(max_seq, window)``,
    mamba conv state in ``dtype`` and SSM state in f32, whisper's cross
    K/V ``(L, B, KH, T_enc, hd)``; ``pos`` an int32 0-d tensor.  Every
    state tensor is its own (decode writes in place).  ``device``
    defaults to the card."""
    _check_family(cfg)
    dev = resolve_device(device)
    L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cl = _cache_len(cfg, max_seq, window)
    pos = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family in _ATTN_FAMILIES:
        return {"k": zeros(L, batch, KH, cl, hd),
                "v": zeros(L, batch, KH, cl, hd), "pos": pos}
    if cfg.family == "audio":
        enc = cfg.encoder.context_len
        return {"k": zeros(L, batch, KH, cl, hd),
                "v": zeros(L, batch, KH, cl, hd),
                "ck": zeros(L, batch, KH, enc, hd),
                "cv": zeros(L, batch, KH, enc, hd), "pos": pos}
    s = cfg.ssm
    if cfg.family == "ssm":
        return {"mamba": {"conv": zeros(L, batch, s.d_conv - 1, cfg.d_inner),
                          "ssm": zeros(L, batch, cfg.d_inner, s.d_state,
                                       dt=torch.float32)},
                "pos": pos}
    H = cfg.d_inner // s.head_dim
    n_apps = cfg.num_layers // cfg.hybrid_period
    return {"mamba": {"conv": zeros(L, batch, s.d_conv - 1,
                                    cfg.d_inner + 2 * s.d_state),
                      "ssm": zeros(L, batch, H, s.head_dim, s.d_state,
                                   dt=torch.float32)},
            "attn": {"k": zeros(n_apps, batch, KH, cl, hd),
                     "v": zeros(n_apps, batch, KH, cl, hd)},
            "pos": pos}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _attn_decode_sublayer(cfg, p, x, k_all, v_all, li, pos, *, window,
                          impl="chunked"):
    """One-token self-attention (+ MLP or MoE) against the STACKED
    heads-major ring ``k/v_all`` ``(L, B, KH, CL, hd)``; layer ``li``'s
    row ``pos mod CL`` takes the token's K/V in place.  The ring's length
    already bounds the window (``window`` is the reference's argument and
    unused), so only unwritten rows are masked: ``min(pos + 1, CL)`` rows
    are live.  ``impl`` ``"kernel"``/``"pallas"`` runs the flash-decode
    kernel; any other the plain ``layers.decode_attention``.  Whisper's
    positions are in its embedding: no RoPE."""
    B = x.shape[0]
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = _project_qkv(cfg, p["attn"], h)
    if cfg.family != "audio":
        cos, sin = Lyr.rope_cos_sin(pos.reshape(1), cfg.head_dim,
                                    cfg.rope_theta)
        q = Lyr.apply_rope(q, cos[None], sin[None])
        k = Lyr.apply_rope(k, cos[None], sin[None])
    CL = k_all.shape[3]
    widx = torch.remainder(pos, CL).reshape(1).long()       # ring row
    k_layer, v_layer = k_all[li], v_all[li]
    k_layer.index_copy_(2, widx, k.transpose(1, 2).to(k_layer.dtype))
    v_layer.index_copy_(2, widx, v.transpose(1, 2).to(v_layer.dtype))
    live = torch.clamp(pos + 1, max=CL)
    if impl in ("kernel", "pallas"):
        att = FD.flash_decode_attention(q, k_layer, v_layer, pos=live)
    else:
        att = Lyr.decode_attention(q, k_layer, v_layer, pos=live)
    x = x + att.reshape(B, 1, -1) @ p["attn"]["wo"]
    ff, _ = feed_forward(cfg, p, _apply_norm(cfg, p["ln2"], x))
    return x + ff


def decode_step(cfg, params, token, cache, *, window=None, attn_impl="chunked",
                ssm_impl="kernel"):
    """token: (B, 1) int.  Returns ``(logits (B, V) f32, new_cache)``.
    K/V rows are written into ``cache``'s tensors in place (module
    docstring); the mamba layers' state comes back as new tensors.
    Whisper adds ``sinusoidal_at(pos)`` to the token's embedding, and its
    cross attention reads every encoder row of ``ck``/``cv`` through the
    plain ``layers.decode_attention``, whatever ``attn_impl``, as the
    reference's does."""
    _check_family(cfg)
    x = params["embed"][token]
    pos = cache["pos"]
    if cfg.family in _ATTN_FAMILIES:
        for li in range(cfg.num_layers):
            x = _attn_decode_sublayer(cfg, layer_params(params, li), x,
                                      cache["k"], cache["v"], li, pos,
                                      window=window, impl=attn_impl)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    elif cfg.family == "audio":
        x = x + Lyr.sinusoidal_at(pos.reshape(1), cfg.d_model).to(
            x.dtype)[None]
        B = x.shape[0]
        ck, cv = cache["ck"], cache["cv"]
        for li in range(cfg.num_layers):
            lp = layer_params(params, li)
            x = _attn_decode_sublayer(cfg, lp, x, cache["k"], cache["v"],
                                      li, pos, window=window, impl=attn_impl)
            xq = (_apply_norm(cfg, lp["ln_x"], x) @ lp["xattn"]["wq"]
                  ).reshape(B, 1, cfg.num_heads, cfg.head_dim)
            att = Lyr.decode_attention(xq, ck[li], cv[li], pos=ck.shape[3])
            x = x + att.reshape(B, 1, -1) @ lp["xattn"]["wo"]
        new_cache = {"k": cache["k"], "v": cache["v"], "ck": ck, "cv": cv,
                     "pos": pos + 1}
    else:
        period = cfg.hybrid_period if cfg.family == "hybrid" else 0
        convs, hs = [], []
        for li in range(cfg.num_layers):
            lp = layer_params(params, li)
            y, nc = SSM.ssm_block(
                cfg, lp["mamba"], _apply_norm(cfg, lp["ln"], x),
                {"conv": cache["mamba"]["conv"][li],
                 "ssm": cache["mamba"]["ssm"][li]}, impl=ssm_impl)
            x = x + y
            convs.append(nc["conv"])
            hs.append(nc["ssm"])
            if period and (li + 1) % period == 0:
                x = _attn_decode_sublayer(
                    cfg, params["shared"], x, cache["attn"]["k"],
                    cache["attn"]["v"], (li + 1) // period - 1, pos,
                    window=window, impl=attn_impl)
        new_cache = {"mamba": {"conv": torch.stack(convs),
                               "ssm": torch.stack(hs)}, "pos": pos + 1}
        if period:
            new_cache["attn"] = cache["attn"]
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = (x[:, 0] @ lm_head_weights(cfg, params)).float()
    return logits, new_cache
