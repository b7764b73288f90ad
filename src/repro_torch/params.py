"""Weights in and out of the port: numpy pytrees and ``.npz`` checkpoints.

A parameter pytree of the JAX package, given as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), becomes the port's nested
dict of tensors with the same keys, shapes and ``(in, out)`` layout.  The
conversion goes through ``torch.from_numpy``, so f32 weights arrive bit
for bit.  It takes numpy arrays only and imports nothing of the JAX
package.  A checkpoint written by ``repro.checkpoint.save_pytree`` loads
through ``load_npz``, and the reference's optimizer state through
``adamw_state_from_numpy``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.optim import AdamWState


def from_numpy(tree, device="cpu") -> Any:
    """Nested dicts/lists of numpy arrays -> the same of tensors on
    ``device`` (dtype kept, JAX's bfloat16 included, so a pytree of mixed
    dtypes carries across leaf by leaf; arrays are copied, never
    aliased)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if not isinstance(arr, np.ndarray) or arr.dtype == object:
        raise TypeError(f"expected a numpy array leaf, got {type(tree)!r}")
    if arr.dtype.name == "bfloat16":        # JAX's bf16 (ml_dtypes): torch
        bits = np.array(arr, copy=True).view(np.uint16)  # reads its bits
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"layers/attn/wq": t, ...}`` -> nested dicts."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def load_npz(path: str, device="cpu") -> Dict[str, Any]:
    """A flat-key ``.npz`` checkpoint (either package's) as the port's
    nested dict of tensors on ``device``."""
    return unflatten(load_pytree(path, device=device))


def adamw_state_from_numpy(step, m, v, device="cpu"):
    """The reference's ``AdamWState`` (its ``step``, ``m`` and ``v`` as
    numpy, e.g. ``jax.tree.map(np.asarray, state)``) as the port's
    ``optim.AdamWState``: the step a host integer, the moments f32
    tensors on ``device`` with the params' keys."""
    return AdamWState(int(np.asarray(step)), from_numpy(m, device),
                      from_numpy(v, device))
