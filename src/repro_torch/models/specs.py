"""Input stand-ins for every (arch x input-shape) pair.

The counterpart of ``repro/models/specs.py``.  What the reference builds
as ``jax.ShapeDtypeStruct``s are tensors on the ``meta`` device here:
the same keys, shapes and dtypes, no storage, and every operator of the
port runs on them (shape inference only).  They are what the dry run
(``repro_torch.launch.dryrun``) counts a step against.
``concrete_inputs`` draws the matching real tensors for smoke runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

META = torch.device("meta")


def _token_len(cfg: ArchConfig, seq_len: int) -> int:
    """Text tokens after reserving frontend positions (vlm)."""
    if cfg.frontend == "vision":
        return seq_len - cfg.frontend_tokens
    return seq_len


def input_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16,
                device=META):
    """``(inputs, cache or None)`` of the shape's kind as tensors on
    ``device`` (meta by default): train ``tokens``/``labels``, prefill
    ``tokens``, each with the vlm's ``vision_embeds`` (its rows carved
    out of ``seq_len``) or whisper's encoder ``frames``; decode one
    ``token`` and ``transformer.init_cache``'s tree at the shape's batch
    and length, the ring clamped to ``effective_window``.  Token ids are
    int32, embeddings and frames ``dtype``."""
    B, S = shape.global_batch, shape.seq_len
    St = _token_len(cfg, S)

    def empty(*dims, dt):
        return torch.empty(dims, dtype=dt, device=device)
    if shape.kind in ("train", "prefill"):
        d = {"tokens": empty(B, St, dt=torch.int32)}
        if shape.kind == "train":
            d["labels"] = empty(B, St, dt=torch.int32)
        if cfg.frontend == "vision":
            d["vision_embeds"] = empty(B, cfg.frontend_tokens, cfg.d_model,
                                       dt=dtype)
        if cfg.frontend == "audio":
            d["frames"] = empty(B, cfg.encoder.context_len, cfg.d_model,
                                dt=dtype)
        return d, None
    if shape.kind == "decode":
        window = T.effective_window(cfg, S)
        cache = T.init_cache(cfg, B, S, dtype=dtype, window=window,
                             device=device)
        return {"token": empty(B, 1, dt=torch.int32)}, cache
    raise ValueError(shape.kind)


def concrete_inputs(cfg: ArchConfig, shape: InputShape,
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
    """Real random tensors matching ``input_specs`` on ``device`` (the
    card unless the caller names the CPU): token ids uniform in the
    vocabulary, embeddings and frames normal * 0.02, each drawn from
    ``generator`` in the specs' order (a generator on ``device`` seeded
    with 0 without one); the cache zero."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    specs, cache_spec = input_specs(cfg, shape, dtype=dtype)
    out = {}
    for name, s in specs.items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, tuple(s.shape),
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(tuple(s.shape), generator=generator,
                                    device=dev, dtype=s.dtype).mul_(0.02)
    cache = None
    if cache_spec is not None:
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             dtype=dtype,
                             window=T.effective_window(cfg, shape.seq_len),
                             device=dev)
    return out, cache
