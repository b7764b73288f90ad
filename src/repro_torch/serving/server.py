"""Batched autoregressive serving loop — a thin wrapper over the slot
pool (``repro_torch.serving.sessions.SessionManager``).

The PyTorch counterpart of ``repro/serving/server.py``.  The NEUKONFIG
pipeline (core/) is the *stage-parallel* server the paper evaluates; this
module is the conventional single-host KV-cache server.  ``run_batch``
admits each request into a ``SessionManager`` slot (ragged prompts, fixed
pad-to-bucket shapes) and steps the whole pool per decode iteration
(``_decode`` is the per-iteration seam the tests hook).

State migration rides on the pool's snapshot/restore: ``export_state``
copies the batch (slot-pool cache + per-request progress) to host
tensors (the reference's numpy trees; bf16 has no numpy type), and
``import_state`` on another server instance resumes it mid-stream on its
own device.

Only text frontends are supported: slot-pool admission embeds token ids
directly, so the vision/audio frontends (which need encoder inputs at
prefill) raise ``NotImplementedError`` at construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.stateful import StatefulStageRunner
from repro_torch.serving.sessions import SessionManager, Slot


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    output: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


class BatchingServer:
    """Static batcher over a ``SessionManager`` slot pool: one slot per
    request, one masked-prefill admission each, whole-pool decode steps.
    ``device`` defaults to the card."""

    def __init__(self, cfg: ArchConfig, params, *, max_seq: int = 128,
                 attn_impl: str = "chunked", device="cuda"):
        if getattr(cfg, "frontend", "text") in ("vision", "audio"):
            raise NotImplementedError(
                "BatchingServer serves text frontends only: slot-pool "
                "admission embeds token ids directly (no encoder inputs)")
        self.cfg, self.params = cfg, params
        self.max_seq = max_seq
        self.attn_impl = attn_impl
        self.device = device
        self._runner: Optional[StatefulStageRunner] = None
        self._sm: Optional[SessionManager] = None   # in-flight batch state

    def _pool(self, num_slots: int) -> SessionManager:
        if self._runner is None:
            # one runner for the server's lifetime: its admission/decode
            # fns are reused across batches
            self._runner = StatefulStageRunner(
                self.cfg, self.params, max_seq=self.max_seq,
                attn_impl=self.attn_impl, device=self.device)
        return SessionManager(self._runner, num_slots=num_slots)

    def _decode(self, sm: SessionManager):
        """One whole-pool decode step — the per-iteration seam tests
        monkeypatch to observe/stop the decode loop."""
        return sm.decode_step()

    def run_batch(self, reqs: List[Request], *,
                  max_steps: Optional[int] = None,
                  resume: bool = False) -> Dict[int, List[int]]:
        """Prefill + decode a batch to completion.

        ``max_steps`` stops after that many decode steps with the batch
        state retained for ``export_state`` (mid-stream migration);
        ``resume=True`` continues from state primed by ``import_state``
        instead of admitting afresh."""
        if resume:
            sm = self._sm
            assert sm is not None, "import_state first"
        else:
            sm = self._pool(len(reqs))
            for r in reqs:
                sm.admit(np.asarray(r.prompt, np.int32), sid=f"r{r.rid}")
            # first token comes straight from the admission prefill
            tok = sm.next_token().tolist()
            for i, r in enumerate(reqs):
                if not r.done:
                    r.output.append(int(tok[i][0]))
        steps = max(r.max_new_tokens for r in reqs)
        taken = 0
        for _ in range(steps - 1):
            if all(r.done for r in reqs):
                # e.g. resumed requests arriving with partial output: no
                # reason to burn `steps - 1` decode steps on a done batch
                break
            if max_steps is not None and taken >= max_steps:
                break
            self._decode(sm)
            tok = sm.next_token().tolist()
            taken += 1
            for i, r in enumerate(reqs):
                if not r.done:
                    r.output.append(int(tok[i][0]))
        self._sm = sm
        return {r.rid: r.output for r in reqs}

    # -- KV migration (beyond-paper demo) -----------------------------------
    def export_state(self, reqs: List[Request]) -> Dict:
        """Copy the in-flight batch to the host: the slot pool's state
        buffers, slot metadata, and per-request progress, so the payload
        can cross a link to another server instance."""
        assert self._sm is not None, "no batch has run on this server"
        snap = self._sm.snapshot()
        return {
            "cache": {k: v.cpu() for k, v in snap["cache"].items()},
            "tok": snap["tokens"].cpu(),
            "bounds": snap["bounds"].cpu(),
            "logits": snap["logits"].cpu(),
            "slots": [(s.index, s.sid, s.pos, s.live, s.last_used, s.epoch)
                      for s in snap["slots"]],
            "parked": snap["parked"],
            "epoch": snap["epoch"],
            "clock": snap["clock"],
            "reqs": [(r.rid, np.asarray(r.prompt), r.max_new_tokens,
                      list(r.output)) for r in reqs],
        }

    def import_state(self, state: Dict) -> List[Request]:
        """Adopt an ``export_state`` payload; returns the rebuilt request
        batch, ready for ``run_batch(reqs, resume=True)``."""
        sm = self._pool(len(state["slots"]))
        sm.restore({
            "cache": dict(state["cache"]),
            "tokens": state["tok"],
            "bounds": state["bounds"],
            "logits": state["logits"],
            "slots": [Slot(*t) for t in state["slots"]],
            "parked": dict(state["parked"]),
            "epoch": state["epoch"],
            "clock": state["clock"],
        })
        self._sm = sm
        return [Request(rid, prompt, max_new, output=list(out))
                for rid, prompt, max_new, out in state["reqs"]]


def state_nbytes(state: Dict) -> int:
    """Payload size of an ``export_state`` tree (the migration's cost)."""
    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()
    return sum(nbytes(t) for t in state["cache"].values()) \
        + nbytes(state["tok"])
