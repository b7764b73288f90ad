"""Train, prefill and decode step factories.

The counterpart of ``repro/training/steps.py``: each factory closes over
the config (and the optimizer) and returns a function of tensors.  The
train step differentiates ``transformer.train_loss`` with autograd,
through the chunked flash attention's blockwise backward
(``layers._ChunkedAttention``) and the SSM blocks' plain scans; the
kernels have no backward, so their routes are refused here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.stages import tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import clip_by_global_norm_

_KERNEL_ROUTES = ("kernel", "pallas")


def make_train_step(cfg: ArchConfig, *, optimizer=None, attn_impl="chunked",
                    remat=True, clip_norm: float = 1.0):
    """``(train_step, init_opt)``.  ``train_step(params, opt_state,
    batch)`` takes the loss's gradient of every param, clips them to
    ``clip_norm`` by their global norm and applies the optimizer (AdamW
    at 1e-4 by default), which writes the params in place; it returns
    ``(params, opt_state, metrics)``, the metrics (``loss``, ``ce``,
    ``aux``, ``grad_norm``) 0-d tensors on the params' device, read by
    nobody until the caller reads them."""
    if attn_impl in _KERNEL_ROUTES:
        raise ValueError(f"attn_impl {attn_impl!r} runs the flash-attention "
                         f"kernel, which has no backward; train with "
                         f"'chunked' (or 'naive')")
    init_opt, update_opt = optimizer if optimizer is not None else adamw(1e-4)

    def train_step(params, opt_state, batch: Dict[str, Any]):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss, metrics = T.train_loss(cfg, live, batch, attn_impl=attn_impl,
                                     remat=remat)
        found = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

        def grad_of(p):                     # an unused leaf's is zero
            g = next(found)
            return torch.zeros_like(p) if g is None else g
        grads = tree_map(grad_of, params)
        del live, leaves
        gnorm = clip_by_global_norm_(grads, clip_norm)
        params, opt_state = update_opt(grads, opt_state, params)
        metrics = {"ce": metrics["ce"].detach(),
                   "aux": metrics["aux"].detach(), "loss": loss.detach(),
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step, init_opt


def make_prefill_step(cfg: ArchConfig, shape: InputShape, *,
                      attn_impl="chunked", remat=True):
    """``prefill_step(params, inputs) -> (logits, cache)`` at the shape's
    window (``transformer.effective_window``)."""
    window = T.effective_window(cfg, shape.seq_len)

    def prefill_step(params, inputs):
        return T.prefill(cfg, params, inputs, max_seq=shape.seq_len,
                         attn_impl=attn_impl, window=window, remat=remat)

    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: InputShape, *,
                    attn_impl="chunked"):
    """Decode: ONE new token against a cache of ``shape.seq_len``
    entries, ``serve_step(params, token, cache) -> (logits, cache)``."""
    window = T.effective_window(cfg, shape.seq_len)

    def serve_step(params, token, cache):
        return T.decode_step(cfg, params, token, cache, window=window,
                             attn_impl=attn_impl)

    return serve_step
