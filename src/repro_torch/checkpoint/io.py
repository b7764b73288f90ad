"""Flat-key .npz checkpointing of a nested dict of tensors.

The keys are the reference's (``repro/checkpoint/io.py:_flatten``):
``"layers/attn/wq"`` and so on, so a checkpoint the JAX package writes in
f32 loads here and the reverse.  Pause-and-Resume reloads its model from
such a file — exactly the cost Dynamic Switching avoids by keeping donor
weights in memory.

numpy has no bfloat16.  A bf16 tensor is stored as its raw 16-bit
pattern (``uint16``) under its own key, and the names of all such keys
are listed under ``BF16_KEYS``; loading views those arrays back as bf16.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

BF16_KEYS = "__bfloat16_keys__"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if bf16 else t


def save_pytree(tree, path: str) -> int:
    """Returns bytes written."""
    flat = _flatten(tree)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    bf16 = sorted(k for k, v in flat.items() if v.dtype == torch.bfloat16)
    if bf16:
        arrays[BF16_KEYS] = np.asarray(bf16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    return os.path.getsize(path)


def load_pytree(path: str, like=None, device=None):
    """Reload as tensors.  Without ``like``: the flat dict, on ``device``
    (CPU by default).  With ``like``: its nested structure, each leaf on
    the device, in the dtype and in the memory layout (strides: a CNN's
    conv weights, ``models/cnn.py``) of its counterpart in ``like``."""
    with np.load(path) as data:
        bf16 = set(data[BF16_KEYS].tolist()) if BF16_KEYS in data.files \
            else set()
        flat: Dict[str, Any] = {k: _from_numpy(data[k], k in bf16)
                                for k in data.files if k != BF16_KEYS}
    if like is None:
        return {k: v.to(device) if device is not None else v
                for k, v in flat.items()}
    return _rebuild(like, flat)


def _rebuild(sub, flat, prefix=""):
    """``sub``'s structure with each leaf from ``flat``, on the leaf's
    device and in its dtype.  A module function, not a closure: a closure
    that calls itself is a reference cycle, which would keep ``flat``, the
    whole host copy of the checkpoint, alive until a full garbage
    collection freed it on whichever thread ran then."""
    if isinstance(sub, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in sub.items()}
    if isinstance(sub, (list, tuple)):
        return type(sub)(_rebuild(v, flat, f"{prefix}{i}/")
                         for i, v in enumerate(sub))
    src = flat[prefix[:-1]]
    if sub.is_contiguous():
        return src.to(device=sub.device, dtype=sub.dtype)
    out = torch.empty_strided(sub.shape, sub.stride(), dtype=sub.dtype,
                              device=sub.device)
    return out.copy_(src)
