"""Data pipeline: synthetic-but-learnable token streams for training, and a
frame/request source for serving (the paper's video-analytics workload).

The counterpart of ``repro/data/pipeline.py``, carried over unchanged:
numpy only, so for the same seed both packages yield the same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


class SyntheticTokens:
    """Deterministic Markov-ish token stream.

    Not uniform noise: token t+1 = (a*t + drift) % vocab with state-dependent
    drift, so a model CAN reduce loss below ln(V) — used by the training
    convergence tests and the train example.
    """

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.rng = np.random.default_rng(seed)
        self.vocab = cfg.vocab_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, S, V = self.batch, self.seq, self.vocab
        start = self.rng.integers(0, V, (B, 1))
        mult = self.rng.choice([1, 2, 3], (B, 1))
        idx = np.arange(S + 1)[None, :]
        toks = (start + mult * idx) % V
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.frontend == "vision":
            batch["vision_embeds"] = self.rng.standard_normal(
                (B, self.cfg.frontend_tokens, self.cfg.d_model),
                dtype=np.float32) * 0.02
        if self.cfg.frontend == "audio":
            batch["frames"] = self.rng.standard_normal(
                (B, self.cfg.encoder.context_len, self.cfg.d_model),
                dtype=np.float32) * 0.02
        return batch


@dataclass
class Frame:
    t_arrival: float
    frame_id: int
    data: np.ndarray


class FrameSource:
    """Camera analogue: frames arrive at `fps`; payload is a token sequence
    (the stub for a video frame fed to the partitioned DNN)."""

    def __init__(self, cfg: ArchConfig, fps: float, seq: int = 32,
                 seed: int = 0):
        self.cfg, self.fps, self.seq = cfg, fps, seq
        self.rng = np.random.default_rng(seed)
        self._i = 0

    def frames(self, duration: float):
        t, dt = 0.0, 1.0 / self.fps
        while t < duration:
            data = self.rng.integers(0, self.cfg.vocab_size,
                                     (1, self.seq)).astype(np.int32)
            yield Frame(t, self._i, data)
            self._i += 1
            t += dt
