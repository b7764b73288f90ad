"""Per-layer profiling: the data behind Eq. 1 (T_inf = T_e + T_t + T_c).

The counterpart of ``repro/core/profiler.py``: the measured CNN profile
(``profile_cnn``: each unit timed on its device, synchronised), FLOPs/spec
estimation (``profile_transformer``) — the paper's "estimation-based"
path [18] — and the rescaling of that profile to MEASURED decode walls
(``calibrate_decode``), and the per-mesh latency model of a
tensor-parallel cloud stage with its calibration to measured walls
(``calibrate_mesh``), its collectives priced on the H100's NVLink.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, CNNConfig
from repro_torch.core.hardware import (CLOUD_SPEC, EDGE_SPEC, NVLINK_BW,
                                      DeviceSpec)
from repro_torch.core.network import NetworkModel
from repro_torch.core.stages import tree_leaves
from repro_torch.core.timing import Stopwatch
from repro_torch.device import synchronize

@dataclass
class UnitProfile:
    name: str
    t_edge: float           # s, compute on edge
    t_cloud: float          # s, compute on cloud
    boundary_bytes: int     # activation bytes if we split AFTER this unit
    flops: float = 0.0


@dataclass
class ModelProfile:
    arch: str
    units: List[UnitProfile]
    # lazily-built prefix sums: (n, cum t_edge, cum t_cloud).  Makes
    # ``latency`` O(1) and therefore ``latency_curve``/``optimal_split``
    # O(n) instead of O(n²) — the partitioner re-solves Eq. 1 on every
    # network sample, so this is the controller's hot path.
    _psum: Optional[tuple] = field(default=None, init=False, repr=False,
                                   compare=False)
    # bumped by invalidate_cache(); downstream memos (e.g. switch_pool's
    # optimal_split cache) key on (profile, version, len(units))
    _version: int = field(default=0, init=False, repr=False, compare=False)
    # per-mesh latency model: mesh_shape -> (alpha, beta) scales on the
    # analytic terms (``mesh_cloud_time``); an absent shape is (1.0, 1.0).
    # Filled by ``calibrate_mesh`` from measured sharded-cloud walls.
    mesh_models: Dict[Tuple[int, ...], Tuple[float, float]] = \
        field(default_factory=dict, repr=False, compare=False)

    def num_splits(self) -> int:
        return len(self.units) - 1  # split after unit i, i in [0, n-2]

    def cache_token(self) -> tuple:
        """Identity for memos over this profile's current timing data."""
        return (id(self), self._version, len(self.units))

    def _prefix(self) -> tuple:
        n = len(self.units)
        cached = self._psum
        if cached is not None and cached[0] == n:
            return cached
        pe = np.cumsum([u.t_edge for u in self.units])
        pc = np.cumsum([u.t_cloud for u in self.units])
        pb = np.cumsum([u.boundary_bytes for u in self.units])
        self._psum = (n, pe, pc, pb)
        return self._psum

    def invalidate_cache(self) -> None:
        """Call after mutating unit timings in place (adding/removing units
        is detected automatically)."""
        self._psum = None
        self._version += 1

    @staticmethod
    def mesh_tp(mesh_shape) -> int:
        """Tensor-parallel degree of a cloud mesh shape (last axis; a
        leading data axis cannot help a batch-of-1 serving stream)."""
        return int(mesh_shape[-1]) if mesh_shape else 1

    def mesh_model(self, mesh_shape) -> Tuple[float, float]:
        """Calibration scales ``(alpha, beta)`` for a mesh shape: alpha
        multiplies the 1/tp compute term, beta the ring-collective term."""
        if mesh_shape is None:
            return (1.0, 1.0)
        return self.mesh_models.get(tuple(mesh_shape), (1.0, 1.0))

    def mesh_cloud_time(self, t_cloud: float, coll_bytes: float,
                        mesh_shape) -> float:
        """Per-mesh cloud-stage time.  The uncalibrated default:

            t = alpha * t_cloud / tp                       (compute, 1/tp)
              + beta * 2(tp-1)/tp * coll_bytes / NVLINK_BW (ring all-reduce)

        ``coll_bytes`` is the summed per-unit activation volume of the
        cloud range (each tensor-parallel layer all-reduces its
        residual-stream partials)."""
        tp = self.mesh_tp(mesh_shape)
        if tp <= 1:
            return t_cloud
        alpha, beta = self.mesh_model(mesh_shape)
        t_coll = 2.0 * (tp - 1) / tp * float(coll_bytes) / NVLINK_BW
        return alpha * t_cloud / tp + beta * t_coll

    def latency(self, split: int, net: NetworkModel, mesh_shape=None):
        """(T_e, T_t, T_c) for a split after unit `split` (Eq. 1).

        ``mesh_shape`` prices the CLOUD side on a tensor-parallel mesh of
        that shape via the per-mesh latency model (``mesh_cloud_time``)."""
        n, pe, pc, pb = self._prefix()
        t_e = float(pe[split])
        t_c = float(pc[n - 1] - pc[split])
        if mesh_shape is not None:
            coll = float(pb[n - 1] - pb[split])
            t_c = self.mesh_cloud_time(t_c, coll, mesh_shape)
        t_t = net.transfer_time(self.units[split].boundary_bytes)
        return t_e, t_t, t_c

    def total_latency(self, split: int, net: NetworkModel,
                      mesh_shape=None) -> float:
        return sum(self.latency(split, net, mesh_shape))


# ---------------------------------------------------------------------------
# measured profiling (CNNs)
# ---------------------------------------------------------------------------

def _time_fn(fn, *args, device: torch.device, reps: int = 3) -> float:
    """Mean wall of ``fn(*args)`` over ``reps`` calls after two warm-up
    calls, the device synchronised before and after (JAX blocks until
    ready).  The reference warms up once, paying its compile; an eager
    first call pays one-time set-up instead (oneDNN primitives on the CPU,
    up to the second call; cuDNN's heuristics on the card)."""
    for _ in range(2):
        fn(*args)
    synchronize(device)
    sw = Stopwatch()
    for _ in range(reps):
        fn(*args)
    synchronize(device)
    return sw.elapsed() / reps


def profile_cnn(cfg: CNNConfig, params, units, shapes, *, batch: int = 1,
                edge: DeviceSpec = EDGE_SPEC, cloud: DeviceSpec = CLOUD_SPEC,
                dtype=torch.float32, reps: int = 3) -> ModelProfile:
    """Measured per-unit times on this host, scaled to edge/cloud specs.

    The host measurement fixes the *relative* per-layer cost; the edge/cloud
    specs set absolute scale (host flops assumed = cloud spec, the edge
    slower by ``cloud.flops / edge.flops``).  Units run on the params'
    device (the runner's)."""
    device = tree_leaves(params)[0].device
    x = torch.zeros((batch, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    dtype=dtype, device=device)
    out_profiles = []
    scale_edge = cloud.flops / edge.flops
    with torch.no_grad():
        for i, (name, fn) in enumerate(units):
            t = _time_fn(fn, params[i], x, device=device, reps=reps)
            bbytes = int(np.prod(shapes[i])) * batch \
                * np.dtype(np.float32).itemsize
            out_profiles.append(UnitProfile(name, t * scale_edge, t, bbytes))
            x = fn(params[i], x)
    return ModelProfile(cfg.name, out_profiles)


# ---------------------------------------------------------------------------
# analytic profiling (full-size transformers)
# ---------------------------------------------------------------------------

def _layer_flops(cfg: ArchConfig, kind: str, tokens: int, seq: int) -> float:
    """Forward FLOPs of one decoder layer over `tokens` tokens."""
    d = cfg.d_model
    if kind == "attn":
        hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        proj = 2 * tokens * d * hd * (2 * H + 2 * KH)
        ctx = min(seq, cfg.sliding_window or seq)
        att = 2 * 2 * tokens * ctx * H * hd   # QK^T + PV (upper bound, causal)
        if cfg.moe is not None:
            m = cfg.moe
            ffn = 2 * tokens * 3 * d * (m.top_k * m.expert_d_ff
                                        + (m.shared_d_ff if m.num_shared_experts else 0))
        else:
            n_mats = 3 if cfg.gated_mlp else 2
            ffn = 2 * tokens * n_mats * d * cfg.d_ff
        return proj + att + ffn
    if kind == "mamba1":
        di, s = cfg.d_inner, cfg.ssm
        return 2 * tokens * (d * 2 * di + di * (s.dt_rank + 2 * s.d_state)
                             + s.dt_rank * di + di * d) \
            + 6 * tokens * di * s.d_state
    if kind == "mamba2":
        di, s = cfg.d_inner, cfg.ssm
        H = di // s.head_dim
        return 2 * tokens * d * (2 * di + 2 * s.d_state + H) \
            + 2 * tokens * di * d + 6 * tokens * di * s.d_state
    raise ValueError(kind)


def profile_transformer(cfg: ArchConfig, *, seq: int, batch: int = 1,
                        edge: DeviceSpec = EDGE_SPEC,
                        cloud: DeviceSpec = CLOUD_SPEC,
                        act_bytes: int = 2) -> ModelProfile:
    """Analytic Eq.-1 profile.  Units: [embed] + decoder layers + [head].

    Boundary bytes between decoder layers are batch*seq*d_model*act_bytes —
    constant for transformers, which is itself a finding (section 4 of
    DESIGN.md): the optimal split for a uniform-width transformer is driven
    purely by compute balance, unlike VGG (Fig. 2) where activation volume
    varies 100x across layers.
    """
    tokens = batch * seq
    bbytes = batch * seq * cfg.d_model * act_bytes
    units = [UnitProfile("embed", 0.0, 0.0, bbytes, 0.0)]
    kinds = list(cfg.layer_kinds())
    if cfg.family == "hybrid" and cfg.hybrid_period:
        # insert the shared attn applications as units
        out = []
        for i, k in enumerate(kinds):
            out.append(k)
            if (i + 1) % cfg.hybrid_period == 0:
                out.append("attn")
        kinds = out
    for i, kind in enumerate(kinds):
        fl = _layer_flops(cfg, kind, tokens, seq)
        units.append(UnitProfile(
            f"{kind}{i}",
            fl / (edge.flops * edge.mfu),
            fl / (cloud.flops * cloud.mfu),
            bbytes, fl))
    head_fl = 2 * tokens * cfg.d_model * cfg.vocab_size
    units.append(UnitProfile("head", head_fl / (edge.flops * edge.mfu),
                             head_fl / (cloud.flops * cloud.mfu), 0, head_fl))
    return ModelProfile(cfg.name, units)


# ---------------------------------------------------------------------------
# measured-decode calibration
# ---------------------------------------------------------------------------

def calibrate_decode(profile: ModelProfile, timings: Sequence, *,
                     split: int) -> Tuple[float, float]:
    """Rescale per-unit timings so Eq.-1 pricing matches MEASURED decode.

    ``timings`` are measured per-token stage walls from the serving path
    (any objects with ``t_edge``/``t_cloud`` attributes, e.g. the
    ``RequestTiming``s that ``StatefulEdgeCloudPipeline.process``
    returns), taken at a known ``split`` — the same split-after-unit
    index ``latency``/``optimal_split`` use (for a stateful pipeline at
    layer split ``s`` that is ``stateful.unit_index_of_split(cfg, s)``).
    The medians fix the absolute scale of the edge and cloud sides; the
    analytic profile keeps fixing the *relative* per-layer shape.  This
    is what lets ``optimal_split`` price the kernel-routed decode path
    (``decode_impl="kernel"``) instead of whatever spec sheet the
    analytic profile assumed: after a decode-path speedup the measured
    walls shrink, the profile shrinks with them, and the split optimum
    moves accordingly.

    Mutates ``profile`` in place (``invalidate_cache`` is called, so
    memoized ``optimal_split`` results are correctly dropped) and
    returns the applied ``(edge_scale, cloud_scale)``."""
    def med(xs):
        return float(np.median(np.asarray(xs, np.float64)))
    t_edge = med([t.t_edge for t in timings])
    t_cloud = med([t.t_cloud for t in timings])
    n, pe, pc, _ = profile._prefix()
    pred_e = float(pe[split])
    pred_c = float(pc[n - 1] - pc[split])
    scale_e = t_edge / pred_e if pred_e > 0 and t_edge > 0 else 1.0
    scale_c = t_cloud / pred_c if pred_c > 0 and t_cloud > 0 else 1.0
    for u in profile.units:
        u.t_edge *= scale_e
        u.t_cloud *= scale_c
    profile.invalidate_cache()
    return scale_e, scale_c


def calibrate_mesh(profile: ModelProfile, timings: Sequence, *, split: int,
                   mesh_shape) -> Tuple[float, float]:
    """Fit the per-mesh latency model to MEASURED sharded-cloud walls
    (objects with a ``t_cloud``) of a pipeline whose cloud stage ran on a
    mesh of ``mesh_shape`` at ``split``.  One measurement point fits one
    scale: alpha and beta move together by measured/predicted, keeping
    the analytic compute/collective ratio.  Stores the scales on
    ``profile.mesh_models`` and bumps the cache version."""
    if mesh_shape is None or ModelProfile.mesh_tp(mesh_shape) <= 1:
        return (1.0, 1.0)
    mesh_shape = tuple(int(d) for d in mesh_shape)
    t_cloud = float(np.median(np.asarray([t.t_cloud for t in timings],
                                         np.float64)))
    n, pe, pc, pb = profile._prefix()
    base_c = float(pc[n - 1] - pc[split])
    coll = float(pb[n - 1] - pb[split])
    # predict with the CURRENT scales, then apply the correction ratio
    pred = profile.mesh_cloud_time(base_c, coll, mesh_shape)
    scale = t_cloud / pred if pred > 0 and t_cloud > 0 else 1.0
    alpha, beta = profile.mesh_model(mesh_shape)
    profile.mesh_models[mesh_shape] = (alpha * scale, beta * scale)
    profile.invalidate_cache()
    return profile.mesh_models[mesh_shape]
