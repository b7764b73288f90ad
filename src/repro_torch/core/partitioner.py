"""Optimal split-point selection (the paper's "identify new metadata" step).

Minimises Eq. 1 over all split points given a ModelProfile and the current
NetworkModel.  Also exposes the full latency curve used to reproduce
Figs. 2-3 and a memory-feasibility filter (the paper notes the edge cannot
host partitions when <=10% memory is available).

Complexity: ``ModelProfile.latency`` is O(1) via cached prefix sums, so
``latency_curve`` and ``optimal_split`` are O(n) in the number of units —
cheap enough to re-solve on every network sample (the controller does),
see ``benchmarks/switch_micro.py`` for the scaling measurement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.network import NetworkModel
from repro_torch.core.profiler import ModelProfile


@dataclass
class SplitDecision:
    split: int                      # split AFTER unit index `split`
    t_edge: float
    t_transfer: float
    t_cloud: float

    @property
    def total(self) -> float:
        return self.t_edge + self.t_transfer + self.t_cloud


def latency_curve(profile: ModelProfile, net: NetworkModel,
                  mesh_shape: Optional[Tuple[int, ...]] = None
                  ) -> List[SplitDecision]:
    out = []
    for s in range(profile.num_splits()):
        te, tt, tc = profile.latency(s, net, mesh_shape=mesh_shape)
        out.append(SplitDecision(s, te, tt, tc))
    return out


def optimal_split(profile: ModelProfile, net: NetworkModel,
                  edge_mem_budget: Optional[int] = None,
                  unit_mem_bytes: Optional[List[int]] = None,
                  *, mesh_shape: Optional[Tuple[int, ...]] = None
                  ) -> SplitDecision:
    """argmin_{split} T_e + T_t + T_c, optionally memory-feasible on the edge.

    ``mesh_shape`` prices the CLOUD term with the per-mesh latency model
    (``ModelProfile.mesh_cloud_time``) so the optimum can move when the
    cloud stage is tensor-parallel: sharding shrinks T_c, which pushes the
    best split EARLIER (ship more layers to the now-faster cloud)."""
    best = None
    for cand in latency_curve(profile, net, mesh_shape):
        if edge_mem_budget is not None and unit_mem_bytes is not None:
            if sum(unit_mem_bytes[:cand.split + 1]) > edge_mem_budget:
                continue
        if best is None or cand.total < best.total:
            best = cand
    if best is None:
        raise RuntimeError("no memory-feasible split (paper: <=10% edge memory)")
    return best


def should_repartition(profile: ModelProfile, current_split: int,
                       net: NetworkModel, min_gain: float = 0.0,
                       *, best: Optional[SplitDecision] = None,
                       mesh_shape: Optional[Tuple[int, ...]] = None
                       ) -> Tuple[bool, SplitDecision]:
    """The paper repartitions whenever the optimum moved; ``min_gain`` > 0 is
    the beyond-paper hysteresis knob (relative latency gain required).
    Pass ``best`` to reuse an already-computed optimum."""
    if best is None:
        best = optimal_split(profile, net, mesh_shape=mesh_shape)
    if best.split == current_split:
        return False, best
    cur = profile.total_latency(current_split, net, mesh_shape=mesh_shape)
    gain = (cur - best.total) / cur if cur > 0 else 0.0
    return gain > min_gain, best
