"""Training loop with checkpointing: the train-side end-to-end entry point.

The counterpart of ``repro/training/loop.py``: weights from the port's
``init_model`` (a ``torch.Generator`` seeded with ``seed`` on the device),
AdamW under the reference's cosine schedule, the synthetic Markov token
stream, each step timed from its first launch to the loss's host read,
and ``.npz`` checkpoints that ``repro.checkpoint.load_pytree`` reads.  It
runs on the card unless the caller names another device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import ArchConfig
from repro_torch.core.timing import Stopwatch
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.training.steps import make_train_step


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, log_every: int = 10,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0, remat: bool = True,
          log_fn: Callable[[str], None] = print,
          device="cuda") -> Dict[str, list]:
    """``steps`` AdamW steps of ``train_loss`` on f32 weights; returns
    ``{"loss": [...], "step_time": [...]}`` (seconds a step).  ``log_fn``
    gets a line every ``log_every`` steps (0: never)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_model(cfg, gen, device=dev)
    opt = adamw(schedule=cosine_schedule(lr, warmup=max(steps // 20, 1),
                                         total=steps))
    step_fn, init_opt = make_train_step(cfg, optimizer=opt, remat=remat)
    opt_state = init_opt(params)
    it = iter(SyntheticTokens(cfg, batch, seq, seed=seed))
    hist = {"loss": [], "step_time": []}
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        sw = Stopwatch()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = sw.elapsed()
        hist["loss"].append(loss)
        hist["step_time"].append(dt)
        if log_every and i % log_every == 0:
            log_fn(f"step {i:5d} loss {loss:.4f} "
                   f"({dt * 1e3:.0f} ms/step)")
        if checkpoint_path and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            save_pytree(params, checkpoint_path)
    if checkpoint_path:
        save_pytree(params, checkpoint_path)
    return hist
