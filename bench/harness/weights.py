"""The benchmark's weights, made from the seed on the device.

A configuration's family (``bench/families/<family>/weights.py``, found by
the ``port``'s ``family``) gives the tree: ``leaves(port)``, every normal
leaf ``(path, shape, std)`` in draw order, and ``constants(port, tree,
gen, dtype, device)``, which puts in the rest (norm scales, biases, the
f32 constants) and may draw from ``gen`` after the leaves.  The normal
leaves are drawn here in ONE call into one buffer of the served dtype and
carved into views.  The values are the benchmark's own, so the reference
(``bench/families/<family>/reference.py``) reads the same weights and
nothing the program made.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from bench.harness import spec as S


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def make_weights(port: dict, seed: int, device, dtype=torch.bfloat16,
                 root: Path = S.ROOT) -> dict:
    """The weight tree of ``port`` drawn from ``seed`` on ``device``."""
    family = S.family(port["family"], "weights", root)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = family.leaves(port)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    off = 0
    for path, shape, std in leaves:
        n = math.prod(shape)
        _put(tree, path, flat[off:off + n].view(shape).mul_(std))
        off += n
    family.constants(port, tree, gen, dtype, device)
    return tree
