"""AdamW and a cosine schedule, written out by hand.

The counterpart of ``repro/optim/adamw.py``, with its arithmetic: f32
moments, bias correction, weight decay on tensors of ``ndim >= 2`` only
(a stacked layer's norm scales are 2-D, so they decay too), the update
computed in f32 and cast back to the param's dtype.  ``torch.optim.AdamW``
decays every tensor and counts steps otherwise, so it is not used.

Params, gradients and moments are nested dicts of tensors.  The step
counter is a host integer, so a step never waits for the card to learn
it; the schedule's rate and the bias corrections are f32 scalars as the
reference computes them.  ``update`` writes the params and the moments in
place and returns them, the counterpart of the reference's jitted step
donating its buffers: at qwen2.5-3b's 3.09 B f32 params a second copy of
the state would not fit beside the first on one card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.stages import tree_leaves, tree_map

_F32 = np.float32


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def _each(fn, tree, *rest) -> None:
    """``fn`` on each leaf of ``tree`` and the leaves at the same keys of
    ``rest`` (matched by key: the reference's pytrees order them
    otherwise)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _each(fn, v, *(r[k] for r in rest))
    else:
        fn(tree, *rest)


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; the rate at a step in f32, as the reference's."""
    def lr(step) -> float:
        step = _F32(step)
        if step < warmup:
            return float(_F32(base_lr) * step / _F32(max(warmup, 1)))
        prog = np.clip((step - _F32(warmup)) / _F32(max(total - warmup, 1)),
                       _F32(0), _F32(1))
        cos = _F32(0.5) * _F32(base_lr) * (_F32(1) + np.cos(_F32(math.pi)
                                                             * prog))
        return float(cos)
    return lr


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          schedule: Optional[Callable[[int], float]] = None):
    """``(init, update)``: ``init(params)`` zero f32 moments on the params'
    devices; ``update(grads, state, params)`` one step, in place (module
    docstring), returning ``(params, AdamWState)``."""
    lr_fn = schedule if schedule is not None else (lambda _: lr)

    def init(params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(0, tree_map(zeros, params),
                          tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        step = state.step + 1
        t = _F32(step)
        lr_t = float(_F32(lr_fn(step)))
        bc1 = float(_F32(1) - _F32(b1) ** t)
        bc2 = float(_F32(1) - _F32(b2) ** t)

        def upd(g, m, v, p):
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            delta = m / bc1
            delta.div_((v / bc2).sqrt_().add_(eps))
            p32 = p.float()           # p itself when it is f32
            if p.dim() >= 2:          # decay matrices only
                delta.add_(p32, alpha=weight_decay)
            p32.sub_(delta.mul_(lr_t))
            if p32 is not p:
                p.copy_(p32)

        _each(upd, grads, state.m, state.v, params)
        return params, AdamWState(step, state.m, state.v)

    return init, update


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled so its global norm is at most max_norm, the norm
    before)``; new tensors, each in its leaf's dtype."""
    out = tree_map(torch.clone, tree)
    return out, clip_by_global_norm_(out, max_norm)


def clip_by_global_norm_(tree, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` in place (the train step's gradients are
    its own); returns the norm before."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / n.clamp_min(1e-9), max=1.0)
    for x in tree_leaves(tree):
        x.mul_(scale)
    return n
