"""Per-request and per-build timing records of an edge-cloud pipeline.

``RequestTiming`` is Eq. 1 for one request (edge wall, priced transfer,
cloud wall); ``BuildReport`` splits a pipeline build into its parts.  The
stateless ``EdgeCloudPipeline`` arrives with the stateless slice; the
stateful decode pipeline lives in ``repro_torch.core.stateful``.
"""
from __future__ import annotations

from dataclasses import dataclass


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
