"""Analytic stand-in pipelines for the chaos benchmark grid.

The port's copy of ``repro/serving/sim.py``, logic unchanged.

The chaos benchmark (``benchmarks/chaos.py``) sweeps {fault plan x
strategy} cells; what it measures is the *control plane* — retries,
watchdog aborts, degraded-mode transitions — not XLA compile times.
``SimPipeline`` therefore prices a request analytically (per-unit edge
and cloud seconds plus the real ``NetworkModel`` transfer price, so a
dead link still returns ``inf``) and ``SimPool`` charges pipeline
builds to an attached ``VirtualClock`` at a scripted cost instead of
compiling anything.  Every number is deterministic, which is what lets
the chaos smoke assert byte-identical timelines across runs.

The fault-injection surface is the REAL one: ``SimPool`` inherits
``PipelinePool`` unchanged, so ``plan.on_build`` fires inside
``ensure``, watchdog fencing and background-build coalescing behave
exactly as in production, and a chaos cell exercises the same hardened
code paths the compiled pipelines use.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.network import NetworkModel
from repro_torch.core.pipeline import BuildReport, RequestTiming
from repro_torch.core.pool import PipelinePool


class SimRunner:
    """Layer-count-only runner: enough surface for the pool, the engine's
    degraded-split picker (``edge_param_bytes``) and the strategies."""

    def __init__(self, num_layers: int = 8, unit_bytes: int = 30_000_000):
        self.num_layers = int(num_layers)
        self.unit_bytes = int(unit_bytes)

    @property
    def max_split(self) -> int:
        return self.num_layers

    def edge_param_bytes(self, split: int) -> int:
        """Parameter bytes the edge holds at ``split`` (embedding + the
        first ``split`` layers), one ``unit_bytes`` per unit."""
        return (int(split) + 1) * self.unit_bytes


class SimPipeline:
    """One edge-cloud pipeline at a fixed split, priced analytically.

    ``process`` returns a ``RequestTiming`` built from per-unit stage
    costs and the live ``NetworkModel``'s transfer price — so outages
    (``bandwidth <= 0``) surface as ``inf`` exactly like the compiled
    path, and the engine's ``link_down`` / degraded branches are
    exercised for real.
    """

    def __init__(self, runner: SimRunner, split: int, net: NetworkModel, *,
                 owns_weights: bool = False, t_edge_unit: float = 0.010,
                 t_cloud_unit: float = 0.004, out_bytes: int = 200_000):
        self.runner = runner
        self.split = int(split)
        self.net = net
        self.owns_weights = owns_weights
        # edge hardware is this much slower than the cloud: degraded mode
        # prices residual cloud work at edge speed through this factor
        self.edge_scale = 2.0
        self.t_edge_unit = t_edge_unit
        self.t_cloud_unit = t_cloud_unit
        self.out_bytes = out_bytes
        self.ready = False

    def build(self, sample_inputs, *, cold: bool,
              reload_from: Optional[str] = None) -> BuildReport:
        # the wall cost of a build is charged by SimPool (scripted virtual
        # seconds), not measured here
        self.ready = True
        return BuildReport()

    def warm(self, sample_inputs=None) -> RequestTiming:
        return RequestTiming(0.0, 0.0, 0.0)

    def process(self, inputs, **kwargs):
        assert self.ready, "pipeline not built"
        t_edge = self.split * self.t_edge_unit
        t_cloud = (self.runner.max_split - self.split) * self.t_cloud_unit
        t_transfer = self.net.transfer_time(self.out_bytes)
        return None, RequestTiming(t_edge, t_transfer, t_cloud)

    def live_param_bytes(self) -> int:
        return self.runner.edge_param_bytes(self.split) if self.ready else 0

    def reshard(self) -> int:
        """Analytic pipelines hold no device buffers — a mesh-shape
        transition moves nothing (the pool still records the report)."""
        return 0

    def close(self) -> None:
        self.ready = False


class SimPool(PipelinePool):
    """PipelinePool over SimPipelines with scripted build pricing.

    Attach a ``VirtualClock`` via ``sim_clock`` and every *foreground*
    build (a cache miss on the serving/switch thread) charges
    ``build_cost_s`` virtual seconds (``x cold_mult`` for cold builds).
    A build that FAILS still charges — the attempt burned its wall
    before raising, which is exactly why pause_resume goes dark under
    ``build_fail`` while switch_a keeps serving.  Background builds on
    the ``neukonfig-build`` worker charge nothing: they are the
    overlapped path, off the stream by construction.
    """

    def __init__(self, runner: SimRunner, net: NetworkModel, *,
                 build_cost_s: float = 0.25, cold_mult: float = 4.0,
                 **kwargs):
        kwargs.setdefault("checkpoint_path", "<sim>")
        super().__init__(runner, net, None, **kwargs)
        self.build_cost_s = float(build_cost_s)
        self.cold_mult = float(cold_mult)
        # attached by the benchmark AFTER the initial pipelines exist, so
        # deployment-time builds are free and only mid-stream ones price
        self.sim_clock = None

    def _new_pipeline(self, key) -> SimPipeline:
        return SimPipeline(self.runner, key.split, self.net,
                           owns_weights=key.owns_weights)

    def ensure(self, key, *, owns_weights: bool = False,
               cold: bool = False, reload_from: Optional[str] = None,
               reuse: bool = True):
        try:
            entry, hit = super().ensure(key, owns_weights=owns_weights,
                                        cold=cold, reload_from=reload_from,
                                        reuse=reuse)
        except BaseException:
            # a failed/stalled build consumed its wall before it died
            self._charge_build(cold)
            raise
        if not hit:
            self._charge_build(cold)
        return entry, hit

    def _charge_build(self, cold: bool) -> None:
        clock = self.sim_clock
        if clock is None:
            return
        if threading.current_thread().name.startswith("neukonfig-build"):
            return                      # background worker: off-stream
        clock.charge(self.build_cost_s * (self.cold_mult if cold else 1.0))
