"""EdgeCloudPipeline: two built stages joined by a priced network link.

The counterpart of ``repro/core/pipeline.py``.  ``process``
runs stage-edge (measured wall-clock, synchronised, scaled by the
cloud/edge speed ratio), prices the boundary transfer with the current
``NetworkModel`` (virtual time: there is no real link), and runs
stage-cloud (measured wall-clock, synchronised).  ``RequestTiming`` is
Eq. 1 for one request; ``BuildReport`` splits a build into its parts.  The
stateful decode pipeline lives in ``repro_torch.core.stateful``.

``mesh_shape`` makes the CLOUD stage tensor-parallel
(``repro_torch.distributed.tp`` over ``launch.mesh.make_cloud_mesh``):
the whole weight tree is copied onto the mesh at build time (what
``BuildReport.t_reshard`` times), so a prebuilt standby moves no weights
on the stream.  The edge stage stays on one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.hardware import CLOUD_SPEC, EDGE_SPEC
from repro_torch.core.network import NetworkModel
from repro_torch.core.stages import (StageRunner, param_bytes, to_device,
                                     tree_map)
from repro_torch.core import timing
from repro_torch.core.timing import Stopwatch
from repro_torch.device import synchronize


@dataclass
class RequestTiming:
    t_edge: float
    t_transfer: float
    t_cloud: float

    @property
    def total(self) -> float:
        return self.t_edge + self.t_transfer + self.t_cloud


@dataclass
class BuildReport:
    t_weights: float = 0.0        # weight copy / reload
    t_compile_edge: float = 0.0   # edge stage build incl. its warm-up
    t_compile_cloud: float = 0.0  # cloud stage (+ head) build incl. warm-up
    t_reshard: float = 0.0        # cloud-weight placement onto a mesh
    t_wall: float = 0.0           # end-to-end build wall time

    @property
    def total(self) -> float:
        return (self.t_weights + self.t_compile_edge + self.t_compile_cloud
                + self.t_reshard)


class EdgeCloudPipeline:
    """One edge-cloud pipeline at a fixed split point, its cloud stage on
    one device or, with ``mesh_shape``, on a tensor-parallel mesh.

    The two stages are built one after the other: both run on one card
    and are dispatched by one Python thread, so overlapping their warm-up
    forwards would only interleave them on the interpreter lock (the
    reference overlaps two XLA compilations, which release it)."""

    def __init__(self, runner: StageRunner, split: int, net: NetworkModel,
                 *, edge_scale: float = CLOUD_SPEC.flops / EDGE_SPEC.flops,
                 owns_weights: bool = False,
                 mesh_shape: Optional[tuple] = None):
        self.mesh_shape = tuple(int(d) for d in mesh_shape) \
            if mesh_shape else None
        if self.mesh_shape is not None \
                and not isinstance(runner, StageRunner):
            raise NotImplementedError(f"no sharded cloud stage for "
                                      f"{type(runner).__name__}")
        self.runner = runner
        self.split = split
        self.net = net
        self.edge_scale = edge_scale     # edge is this much slower than host
        self.owns_weights = owns_weights  # True => separate weight buffers (2x mem)
        self.params = runner.params
        # the cloud stage's weights: ``params``, or their copy on the mesh
        self.cloud_params = runner.params
        self.mesh = None
        self.edge_fn = None
        self.cloud_fn = None

    # -- build ----------------------------------------------------------
    def build(self, sample_inputs, *, cold: bool,
              reload_from: Optional[str] = None) -> BuildReport:
        """Build both stages for inputs shaped like ``sample_inputs``.

        cold=True  -> fresh callables, warmed up, cached nowhere: "new
                      container".
        cold=False -> the runner's cached stages: "same container" (hit if
                      this split was built before; otherwise build only).
        reload_from -> reload weights from disk first (Pause-and-Resume:
                      the resumed app re-reads its model file).
        """
        rep = BuildReport()
        r = self.runner
        dev = r.device
        if reload_from is not None:
            from repro_torch.checkpoint import load_pytree
            sw = Stopwatch()
            self.params = load_pytree(reload_from, like=r.params)
            synchronize(dev)
            rep.t_weights = sw.elapsed()
        elif self.owns_weights:
            sw = Stopwatch()
            self.params = tree_map(torch.clone, r.params)
            synchronize(dev)
            rep.t_weights = sw.elapsed()
            timing.count("weight_bytes", param_bytes(self.params))
        else:
            self.params = r.params
        lo_c, hi_c = self.split + 1, r.num_units
        sample = to_device(sample_inputs, dev)
        sw_wall = Stopwatch()
        sw = Stopwatch()
        self.edge_fn = r.stage_executable(0, lo_c, self.params, sample,
                                          fresh=cold)
        rep.t_compile_edge = sw.restart()
        mid = r.stage_out_avals(0, lo_c, self.params, sample)
        if self.mesh_shape is None:
            self.cloud_params = self.params
            self.cloud_fn = r.stage_executable(lo_c, hi_c, self.params, mid,
                                               fresh=cold)
        else:
            from repro_torch.launch.mesh import make_cloud_mesh
            self.mesh = make_cloud_mesh(self.mesh_shape)
            # the cloud container's weight copy lives ON the mesh; placing
            # it at build time is what lets a prebuilt standby pay the
            # reshard off the stream
            swr = Stopwatch()
            self.cloud_params = r.place_on_mesh(self.params, self.mesh)
            self._sync()
            rep.t_reshard = swr.elapsed()
            self.cloud_fn = r.stage_executable(
                lo_c, hi_c, self.cloud_params, mid, fresh=cold,
                mesh=self.mesh)
        rep.t_compile_cloud = sw.elapsed() - rep.t_reshard
        rep.t_wall = rep.t_weights + sw_wall.elapsed()
        return rep

    def reshard(self) -> int:
        """``PipelinePool.activate``'s mesh-transition hook; returns the
        logical bytes moved on the stream.  A built pipeline placed its
        weight copy at build time and a stateless stage holds no state,
        so nothing moves."""
        return 0

    def _sync(self) -> None:
        synchronize(self.runner.device)
        if self.mesh is not None:
            from repro_torch.distributed.tp import synchronize_mesh
            synchronize_mesh(self.mesh)

    def warm(self, sample_inputs) -> RequestTiming:
        """One throwaway forward: the "always-running" warm-up."""
        _, stage_timing = self.process(sample_inputs)
        return stage_timing

    @property
    def ready(self) -> bool:
        return self.edge_fn is not None

    def close(self) -> None:
        """Drop the built stages and weight references (pool eviction)."""
        self.edge_fn = None
        self.cloud_fn = None
        self.params = self.cloud_params = self.mesh = None

    # -- serve ------------------------------------------------------------
    def process(self, inputs, *, batch: int = 1, seq: Optional[int] = None
                ) -> tuple[Any, RequestTiming]:
        assert self.ready, "pipeline not built"
        dev = self.runner.device
        with timing.span("request"):
            inputs = to_device(inputs, dev)
            with timing.timed("request.edge") as edge:
                h = self.edge_fn(self.params, inputs)
                synchronize(dev)
            if seq is None:
                seq = inputs["tokens"].shape[1] if "tokens" in inputs else 1
            bbytes = self.runner.boundary_bytes(self.split, batch, seq)
            t_transfer = self.net.transfer_time(bbytes)
            with timing.timed("request.cloud") as cloud:
                out = self.cloud_fn(self.cloud_params, h)
                self._sync()
            with timing.span("request.logits"):
                logits = out["logits"].to(dev)
        return logits, RequestTiming(edge.wall * self.edge_scale,
                                     t_transfer, cloud.wall)

    # -- memory accounting (Table I) --------------------------------------
    def live_param_bytes(self) -> int:
        """The weights' bytes, and a mesh build's copy at its logical size
        (per shard it holds about 1/tp of that), as the reference counts."""
        if not self.ready:
            return 0
        n = param_bytes(self.params)
        if self.mesh is not None:
            n += self.cloud_params.logical_bytes
        return n
