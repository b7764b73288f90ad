"""Weights in and out of the port: numpy pytrees and ``.npz`` checkpoints.

A parameter pytree of the JAX package, given as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), becomes the port's nested
dict of tensors with the same keys, shapes and ``(in, out)`` layout.  The
conversion goes through ``torch.from_numpy``, so f32 weights arrive bit
for bit.  It takes numpy arrays only and imports nothing of the JAX
package.  A checkpoint written by ``repro.checkpoint.save_pytree`` loads
through ``load_npz``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree


def from_numpy(tree, device="cpu") -> Any:
    """Nested dicts/lists of numpy arrays -> the same of tensors on
    ``device`` (dtype kept; arrays are copied, never aliased)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if not isinstance(arr, np.ndarray) or arr.dtype == object:
        raise TypeError(f"expected a numpy array leaf, got {type(tree)!r}")
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
