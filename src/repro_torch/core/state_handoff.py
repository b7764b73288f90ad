"""State hand-off accounting for repartitioning STATEFUL pipelines.

The paper's video pipeline is stateless per frame, so Dynamic Switching
only moves requests.  A transformer decode pipeline is stateful: when the
split moves from layer a to layer b, the KV/SSM state of layers [a, b)
changes sides and must cross the link (or be recomputed by re-prefilling).

This module prices both options per architecture — the quantity that
decides which model families suit live repartitioning at all
(DESIGN.md section 4: falcon-mamba hands off MBs where yi-34b hands off GBs).

The ``batch`` axis prices multi-session slot pools: a pool serving N
concurrent sessions hands off N rows of every moved layer's state in one
batched payload, so both arms scale linearly in live-slot count —
``SessionManager.slot_state_bytes`` charges admission/eviction against
its memory budget through the same ``per_layer_state_bytes``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import CLOUD_SPEC, EDGE_SPEC
from repro_torch.core.network import NetworkModel


class HandoffSplitClamped(UserWarning):
    """``plan_handoff`` was asked about a split outside [0, num_layers]."""


def per_layer_state_bytes(cfg: ArchConfig, *, seq_len: int, batch: int = 1,
                          act_bytes: int = 2) -> float:
    """Decode-state bytes of ONE decoder layer at context `seq_len`."""
    if cfg.family == "ssm":
        s = cfg.ssm
        conv = (s.d_conv - 1) * cfg.d_inner * act_bytes
        ssm = cfg.d_inner * s.d_state * 4                    # f32 state
        return batch * (conv + ssm)
    if cfg.family == "hybrid":
        s = cfg.ssm
        conv = (s.d_conv - 1) * (cfg.d_inner + 2 * s.d_state) * act_bytes
        ssm = cfg.d_inner * s.d_state * 4
        mamba = batch * (conv + ssm)
        # shared attention KV amortised over the layers of one period
        window = cfg.sliding_window or seq_len
        kv = batch * 2 * cfg.num_kv_heads * cfg.head_dim \
            * min(seq_len, window) * act_bytes / max(cfg.hybrid_period, 1)
        return mamba + kv
    # attention families
    window = cfg.sliding_window or seq_len
    return batch * 2 * cfg.num_kv_heads * cfg.head_dim \
        * min(seq_len, window) * act_bytes


@dataclass
class HandoffPlan:
    moved_layers: int
    moved_bytes: int
    t_transfer: float        # ship the state across the link
    t_recompute: float       # or re-prefill the moved layers on the target
    best: str                # 'transfer' | 'recompute'

    @property
    def t_best(self) -> float:
        return min(self.t_transfer, self.t_recompute)


def plan_handoff(cfg: ArchConfig, *, old_split: int, new_split: int,
                 seq_len: int, batch: int, net: NetworkModel,
                 target=CLOUD_SPEC, act_bytes: int = 2) -> HandoffPlan:
    """Price moving the decode state of layers between the splits.

    A split ``s`` places layers ``[0, s)`` on the edge, so the state that
    changes sides when the split moves from ``a`` to ``b`` is that of
    layers ``[min(a, b), max(a, b))``.  Splits are clamped into
    ``[0, num_layers]`` once, up front (with a warning): indexing past the
    stack used to silently reprice out-of-range layers as copies of the
    last one, so both arms — and ``moved_bytes`` — were wrong for the
    same inputs.
    """
    kinds = cfg.layer_kinds()
    n = len(kinds)
    clamped_old = min(max(old_split, 0), n)
    clamped_new = min(max(new_split, 0), n)
    if (clamped_old, clamped_new) != (old_split, new_split):
        warnings.warn(
            f"handoff splits ({old_split}, {new_split}) clamped to "
            f"({clamped_old}, {clamped_new}) for a {n}-layer stack",
            HandoffSplitClamped)
    old_split, new_split = clamped_old, clamped_new
    moved = abs(new_split - old_split)
    per_layer = per_layer_state_bytes(cfg, seq_len=seq_len, batch=batch,
                                      act_bytes=act_bytes)
    moved_bytes = int(moved * per_layer)
    t_transfer = net.transfer_time(moved_bytes) if moved else 0.0
    # recompute: re-run the moved layers over the full context on the target
    from repro_torch.core.profiler import _layer_flops
    flops = sum(
        _layer_flops(cfg, kinds[i], tokens=batch * seq_len, seq=seq_len)
        for i in range(min(old_split, new_split), max(old_split, new_split)))
    t_recompute = flops / (target.flops * target.mfu) if moved else 0.0
    best = "transfer" if t_transfer <= t_recompute else "recompute"
    return HandoffPlan(moved, moved_bytes, t_transfer, t_recompute, best)
