"""Shape identities of stage inputs.

The counterparts of ``repro.core.stages.abstractify``/``aval_fingerprint``:
a nested structure of tensors becomes ``TensorSpec``s (shape, dtype,
device), and its fingerprint is a hashable key over structure, shapes and
dtypes.  ``StatefulStageRunner`` caches its built stages on it.  The
stateless ``StageRunner``/``CnnStageRunner`` arrive with the stateless
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of a tensor: what a stage is built for."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


def abstractify(tree):
    """Nested dicts/lists/tuples of tensors -> the same of ``TensorSpec``s
    (specs pass through)."""
    if isinstance(tree, dict):
        return {k: abstractify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstractify(v) for v in tree)
    if isinstance(tree, TensorSpec):
        return tree
    return TensorSpec(tuple(tree.shape), tree.dtype, tree.device)


def materialize(tree):
    """Zero tensors shaped like the specs of ``tree`` (scratch state)."""
    if isinstance(tree, dict):
        return {k: materialize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(v) for v in tree)
    return tree.zeros()


def aval_fingerprint(tree) -> Tuple:
    """Hashable identity of a structure's specs (keys, shapes, dtypes,
    devices) in a fixed order."""
    def walk(t, path, out):
        if isinstance(t, dict):
            for k in sorted(t, key=repr):
                walk(t[k], path + (k,), out)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,), out)
        else:
            out.append((path, t.shape, str(t.dtype), str(t.device)))
        return out
    return tuple(walk(abstractify(tree), (), []))


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
