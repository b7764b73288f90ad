"""PipelineManager: thin facade over the PipelinePool + strategy registry.

The port's copy of ``repro/core/switching.py``, logic unchanged.

The paper's repartitioning mechanisms live in ``repro.core.strategies``
as self-contained ``SwitchStrategy`` classes resolved by name through a
registry (``@register_strategy``), and every built pipeline is owned by
the ``repro.core.pool.PipelinePool`` (keyed by a frozen ``PipelineKey``
— split, owns_weights, cloud mesh shape — LRU-evicted under an
edge-memory budget).  This module keeps the seed's entry point stable::

    mgr = PipelineManager(runner, split=1, net=NetworkModel(20.0),
                          sample_inputs=inputs, standby_split=2)
    report = mgr.repartition("switch_a", 2)          # registry name
    report = mgr.repartition("switch_pool(k=2)", 2)  # parameterised spec

``repartition`` accepts any registered spec string (or a strategy
instance) and caches one instance per spec so stateful strategies (e.g.
``switch_pool``'s bandwidth history) persist across switches.  See
``strategies.py`` for the strategy -> paper-equation mapping and
``available_strategies()`` for the live registry.

Strategies defer standby rebuilds and speculation to the pool's
background ``BuildExecutor``.  The facade keeps the deterministic
semantics callers expect: ``repartition`` drains outstanding background
builds *before* switching (modelling the serving gap between real
bandwidth changes), so back-to-back calls behave exactly like the
synchronous implementation while ``SwitchReport.t_blocked`` still shows
only the pointer-swap cost.  Pass ``drain=False`` to measure overlapped
switching explicitly, and call ``drain()`` for an explicit barrier.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

from repro_torch.core import timing
from repro_torch.core.network import NetworkModel
from repro_torch.core.pool import PipelinePool, PoolEntry, PoolKey
from repro_torch.core.strategies import (SwitchReport, SwitchStrategy,
                                   apply_handoff, available_strategies,
                                   get_strategy)


class PipelineManager:
    """Back-compat facade: owns a PipelinePool and dispatches strategies."""

    def __init__(self, runner, split: int, net: NetworkModel,
                 sample_inputs, *, checkpoint_path: Optional[str] = None,
                 standby_split: Optional[int] = None,
                 standby_owns_weights: bool = True,
                 warm_standbys: bool = False,
                 mem_budget_bytes: Optional[int] = None,
                 pool: Optional[PipelinePool] = None):
        # a pre-built pool (e.g. repro.core.stateful's session-carrying
        # StatefulPipelinePool) is adopted as-is; the facade still owns
        # activating the initial split and the strategy cache
        self.pool = pool if pool is not None else PipelinePool(
            runner, net, sample_inputs,
            checkpoint_path=checkpoint_path,
            mem_budget_bytes=mem_budget_bytes,
            standby_owns_weights=standby_owns_weights,
            warm_standbys=warm_standbys)
        entry, _ = self.pool.ensure(split, cold=False)
        self.pool.activate(entry.key)
        self._strategies: Dict[str, SwitchStrategy] = {}
        if standby_split is not None:
            self.build_standby(standby_split)

    # -- delegated state ---------------------------------------------------
    @property
    def runner(self):
        return self.pool.runner

    @property
    def net(self) -> NetworkModel:
        return self.pool.net

    @property
    def sample_inputs(self):
        return self.pool.sample_inputs

    @property
    def checkpoint_path(self) -> str:
        return self.pool.checkpoint_path

    @property
    def standby_owns_weights(self) -> bool:
        return self.pool.standby_owns_weights

    @property
    def active(self):
        return self.pool.active

    @property
    def standby(self):
        return self.pool.standby

    # -- strategy resolution ----------------------------------------------
    def get_strategy(self, spec: Union[str, SwitchStrategy]) -> SwitchStrategy:
        """Resolve + cache a strategy instance for this manager."""
        if isinstance(spec, SwitchStrategy):
            return spec
        if spec not in self._strategies:
            self._strategies[spec] = get_strategy(spec)
        return self._strategies[spec]

    def repartition(self, strategy: Union[str, SwitchStrategy],
                    new_split: int, *, drain: bool = True) -> SwitchReport:
        if drain:
            self.pool.drain()       # settle background builds first
        strategy = self.get_strategy(strategy)
        with timing.span("switch", strategy=strategy.spec, split=new_split):
            report = strategy.switch(self.pool, new_split)
            apply_handoff(self.pool, report)   # stateful pools: stamp the
        return report                          # executed state hand-off

    def drain(self, timeout=None) -> None:
        """Barrier: wait for all background builds; surface their failures."""
        self.pool.drain(timeout)

    def close(self) -> None:
        """Settle background work and stop the pool's build worker."""
        self.pool.close()

    # -- seed-era conveniences ---------------------------------------------
    def build_standby(self, split: int) -> float:
        return self.pool.build_standby(split)

    def serve(self, inputs):
        """One-shot synchronous request (seed API).  For a measured request
        stream — admission queue, pipelined stage workers, a timeline that
        derives downtime from the stream — drive this manager through
        ``repro.serving.engine.ServingEngine`` instead."""
        entry = self.pool.snapshot_active()
        if entry is None:
            raise RuntimeError("service outage: pipeline paused")
        return entry.pipeline.process(inputs)

    def set_network(self, net: NetworkModel):
        self.pool.set_network(net)

    def set_mesh_shape(self, mesh_shape) -> None:
        """Retarget new builds to a different cloud mesh; the next
        ``repartition`` (any strategy) builds for it and its activation
        reshards weights/state on the stream (``SwitchReport.t_reshard``)."""
        self.pool.set_mesh_shape(mesh_shape)

    def pause_resume(self, new_split: int) -> SwitchReport:
        return self.repartition("pause_resume", new_split)

    def switch_a(self, new_split: int) -> SwitchReport:
        return self.repartition("switch_a", new_split)

    def switch_b1(self, new_split: int) -> SwitchReport:
        return self.repartition("switch_b1", new_split)

    def switch_b2(self, new_split: int) -> SwitchReport:
        return self.repartition("switch_b2", new_split)

    # -- Table I memory accounting ----------------------------------------
    def memory_report(self):
        return self.pool.memory_report()
