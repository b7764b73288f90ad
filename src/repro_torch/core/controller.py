"""NeukonfigController: ties monitor -> partitioner -> strategy together.

The port's copy of ``repro/core/controller.py``, logic unchanged.  It keeps
its own policy registry: the registrations repeat the reference's names,
which the registry lint (NK04) allows inline.

The controller is an **event-driven participant of the serving engine**:
network changes arrive as stream-clock events (the trace's change points,
scheduled by ``repro_torch.serving.engine.ServingEngine`` or by the stand-alone
``run()``), and each event recomputes the optimal split (Eq. 1), asks the
``RepartitionPolicy`` whether to act, and — if so — repartitions with the
configured ``SwitchStrategy`` (any registry spec, e.g. ``"switch_b2"`` or
``"switch_pool(k=2)"``).  When attached to an engine the switch goes
through ``engine.execute_switch`` so the repartition happens *while
requests are in flight* and its measured wall duration blocks the request
stream; detached, the strategy is invoked directly (the legacy
control-only path).  The strategy's ``observe`` hook is fed every network
sample plus the model profile, which is how predictive strategies learn
the bandwidth trend (engines can add denser ``observe_dt`` sampling ticks
between change points).

Strategies run background builds (standby rebuilds, speculation) on the
pool's ``BuildExecutor``.  The controller owns the await points: before a
detached repartition it drains outstanding builds — the gap between
network events is seconds of stream time, so "the background build
finished during the gap" is the semantics a real deployment would see —
and ``run()`` drains once more at the end so callers observe a settled
pool.  (An engine owns that drain itself: ``overlap=True`` leaves builds
in flight across switches to measure the overlapped path.)

Policies (the paper repartitions on *every* change; the others are the
repartition-frequency control its section VI leaves as future work) are an
open registry (``@register_policy``, same pattern as the strategies):

* ``immediate``   — switch whenever the optimum moved and gains anything;
* ``hysteresis``  — require a minimum relative latency gain;
* ``cooldown``    — at most one switch per cooldown window;
* ``slo_aware``   — additionally watches the live ``ServiceTimeline``'s
  rolling p99 on observe ticks and sheds edge load when the SLO is
  violated (repartitions triggered by the measured workload, not just by
  bandwidth change points — ``RepartitionEvent.trigger == "slo_p99"``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from repro_torch.core.network import BandwidthTrace, NetworkModel, NetworkMonitor
from repro_torch.core.partitioner import optimal_split, should_repartition
from repro_torch.core.profiler import ModelProfile
from repro_torch.core.strategies import Registry, SwitchStrategy
from repro_torch.core.switching import PipelineManager, SwitchReport


@dataclass
class RepartitionEvent:
    t: float
    bandwidth_mbps: float
    old_split: int
    new_split: int
    report: Optional[SwitchReport]
    trigger: str = "network"        # "network" | "slo_p99" | "circuit_breaker"


# ---------------------------------------------------------------------------
# repartition policies
# ---------------------------------------------------------------------------

POLICIES = Registry("policy")


def register_policy(name: str, *, override: bool = False):
    """Class decorator adding a RepartitionPolicy to the registry."""
    return POLICIES.register(name, override=override)


class RepartitionPolicy:
    """Decides whether a moved optimum is worth acting on.

    Policies that also want to *initiate* repartitions from the measured
    workload (not just react to network change points) implement
    ``slo_check``: the controller calls it on every engine observe tick
    with the live ``ServiceTimeline`` and repartitions to the returned
    split (``RepartitionEvent.trigger == "slo_p99"``).
    """

    name = "?"

    def should_switch(self, t: float, *, current_split: int, best,
                      profile: ModelProfile, net: NetworkModel) -> bool:
        raise NotImplementedError

    def notify_switched(self, t: float) -> None:
        """Called after a switch actually happened."""


POLICIES.base = RepartitionPolicy


@register_policy("hysteresis")  # nk: allow[NK04]: the port's own registry
class HysteresisPolicy(RepartitionPolicy):
    """Switch only when the relative latency gain clears ``min_gain``."""

    def __init__(self, min_gain: float = 0.05):
        self.min_gain = min_gain

    def should_switch(self, t, *, current_split, best, profile, net):
        do, _ = should_repartition(profile, current_split, net, self.min_gain,
                                   best=best)
        return do


@register_policy("immediate")  # nk: allow[NK04]: the port's own registry
class ImmediatePolicy(HysteresisPolicy):
    """The paper's behaviour: act on every strictly-improving move."""

    def __init__(self):
        super().__init__(min_gain=0.0)


@register_policy("cooldown")  # nk: allow[NK04]: the port's own registry
class CooldownPolicy(RepartitionPolicy):
    """Rate-limit switching: at most one repartition per window."""

    def __init__(self, cooldown_s: float = 10.0):
        self.cooldown_s = cooldown_s
        self._last_switch_t = float("-inf")

    def should_switch(self, t, *, current_split, best, profile, net):
        return best.split != current_split \
            and (t - self._last_switch_t) >= self.cooldown_s

    def notify_switched(self, t):
        self._last_switch_t = t


@register_policy("slo_aware")  # nk: allow[NK04]: the port's own registry
class SloAwarePolicy(RepartitionPolicy):
    """Close the loop on the measured timeline: repartition when the
    rolling p99 violates the latency SLO, not only when the network moves.

    Network change points still go through the hysteresis rule.  On every
    engine observe tick, ``slo_check`` reads the live ``ServiceTimeline``:
    when the rolling-window p99 exceeds ``slo_p99_s``, the policy sheds
    edge load by targeting a *smaller* split (fewer units on the edge —
    the edge stage is the queueing bottleneck, and edge time shrinks
    monotonically with the split).  The target is utilization-guided when
    a profile is available — the largest split whose predicted edge
    occupancy ``lambda * t_edge`` fits ``util_target`` at the measured
    arrival rate — and a one-unit step-down otherwise.  ``cooldown_s``
    paces successive sheds so one burst cannot cascade the split to 1
    before its effect is even measurable.
    """

    def __init__(self, slo_p99_s: float = 0.5, window_s: float = 5.0,
                 cooldown_s: float = 2.0, min_gain: float = 0.0,
                 util_target: float = 0.8):
        self.slo_p99_s = float(slo_p99_s)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.min_gain = float(min_gain)
        self.util_target = float(util_target)
        self._last_switch_t = float("-inf")

    # network change points: the ordinary hysteresis rule
    def should_switch(self, t, *, current_split, best, profile, net):
        do, _ = should_repartition(profile, current_split, net, self.min_gain,
                                   best=best)
        return do

    def notify_switched(self, t):
        self._last_switch_t = t

    def slo_check(self, t: float, timeline, *, current_split: int,
                  profile: Optional[ModelProfile],
                  net: NetworkModel) -> Optional[int]:
        """Target split if the measured rolling p99 violates the SLO."""
        if timeline is None or current_split <= 1:
            return None                  # nothing left to shed
        if (t - self._last_switch_t) < self.cooldown_s:
            return None
        p99 = timeline.rolling_p99(t, self.window_s)
        if math.isnan(p99) or p99 <= self.slo_p99_s:
            return None
        lam = timeline.rolling_arrival_rate(t, self.window_s)
        if profile is not None and lam > 0:
            # largest split (most edge units, least disruption) whose
            # predicted edge occupancy fits the measured arrival rate
            for s in range(current_split - 1, 0, -1):
                if lam * profile.latency(s, net)[0] <= self.util_target:
                    return s
            return 1
        return current_split - 1


def get_policy(spec: Union[str, RepartitionPolicy],
               **overrides) -> RepartitionPolicy:
    """Resolve ``"cooldown(cooldown_s=5.0)"``-style specs (or pass through)."""
    return POLICIES.resolve(spec, **overrides)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class NeukonfigController:
    def __init__(self, mgr: PipelineManager, profile: ModelProfile,
                 trace: BandwidthTrace, *,
                 strategy: Union[str, SwitchStrategy] = "switch_b2",
                 policy: Optional[Union[str, RepartitionPolicy]] = None,
                 min_gain: float = 0.0, poll_dt: float = 1.0,
                 candidate_splits: Optional[Sequence[int]] = None):
        self.mgr = mgr
        self.profile = profile
        self.monitor = NetworkMonitor(trace)
        self.strategy = mgr.get_strategy(strategy)
        if policy is None:
            policy = HysteresisPolicy(min_gain) if min_gain > 0 \
                else ImmediatePolicy()
        self.policy = get_policy(policy)
        # retained as the default observe-tick spacing an engine uses when
        # it wants denser strategy.observe sampling between change events
        self.poll_dt = poll_dt
        self.events: List[RepartitionEvent] = []
        self._engine = None
        if candidate_splits is None:
            # the trace's operating points mapped through Eq. 1 — what a
            # deployment knows up front
            candidate_splits = sorted({optimal_split(profile, trace.at(t)).split
                                       for t, _ in trace.steps})
        self.strategy.prepare(mgr.pool, candidate_splits=candidate_splits)

    # -- engine participation ----------------------------------------------
    def attach(self, engine) -> None:
        """Become a participant of a ServingEngine: switches now go through
        ``engine.execute_switch`` so they are measured on the stream."""
        self._engine = engine

    def network_events(self, duration: float) -> List[float]:
        """Stream-clock times at which network changes arrive: the trace's
        change points, plus t=0 to prime the monitor's baseline sample."""
        return [0.0] + [t for t in self.monitor.trace.change_points()
                        if t <= duration]

    def observe_tick(self, t: float) -> Optional[RepartitionEvent]:
        """Feed the strategy a network sample without change detection
        (an engine's optional denser sampling between change events), and
        give SLO-aware policies their p99 look at the live timeline."""
        net = self.monitor.sample(t)
        self.strategy.observe(self.mgr.pool, net=net, profile=self.profile)
        if self._engine is None:
            return None
        if self._engine.note_network(t, net):
            # breaker transition: the engine already repartitioned
            # (entered or left edge-only degraded mode)
            cur = self.mgr.active.split
            ev = RepartitionEvent(t, net.bandwidth_mbps, cur, cur, None,
                                  trigger="circuit_breaker")
            self.events.append(ev)
            return ev
        if self._engine.in_degraded:
            return None             # split pinned edge-only until recovery
        if not hasattr(self.policy, "slo_check"):
            return None
        current = self.mgr.active.split
        target = self.policy.slo_check(t, self._engine.timeline,
                                       current_split=current,
                                       profile=self.profile, net=net)
        if target is None or target == current:
            return None
        # measured-workload trigger: the stream's own p99 initiated this
        # repartition, not a bandwidth change point
        report = self._engine.execute_switch(self.strategy, target)
        self.policy.notify_switched(t)
        ev = RepartitionEvent(t, net.bandwidth_mbps, current, target, report,
                              trigger="slo_p99")
        self.events.append(ev)
        return ev

    def on_network_event(self, t: float) -> Optional[RepartitionEvent]:
        """Handle one network event at stream time ``t``: detect the
        change, consult the policy, repartition if warranted."""
        net = self.monitor.poll(t)
        if net is None:
            return None
        self.mgr.set_network(net)
        self.strategy.observe(self.mgr.pool, net=net, profile=self.profile)
        if self._engine is not None:
            if self._engine.note_network(t, net):
                # breaker transition handled by the engine (enter/exit
                # edge-only degraded mode); record it and stand down
                cur = self.mgr.active.split
                ev = RepartitionEvent(t, net.bandwidth_mbps, cur, cur, None,
                                      trigger="circuit_breaker")
                self.events.append(ev)
                return ev
            if self._engine.in_degraded:
                # link still dead: Eq.-1 optimisation over an infinite
                # transfer time is meaningless; split stays edge-only
                return None
        current = self.mgr.active.split
        best = optimal_split(self.profile, net)
        do = self.policy.should_switch(t, current_split=current, best=best,
                                       profile=self.profile, net=net)
        ev = RepartitionEvent(t, net.bandwidth_mbps, current, best.split, None)
        if do:
            if self._engine is not None:
                # measured path: the engine charges the switch's wall time
                # to the stream clock and drains in-flight requests on the
                # old pipeline
                ev.report = self._engine.execute_switch(self.strategy,
                                                        best.split)
            else:
                # detached path: await background builds first — event gaps
                # are stream seconds, far longer than a build, so by
                # repartition time they are done
                self.mgr.pool.drain()
                ev.report = self.strategy.switch(self.mgr.pool, best.split)
            self.policy.notify_switched(t)
        self.events.append(ev)
        return ev

    def step(self, t: float) -> Optional[RepartitionEvent]:
        """Back-compat alias for ``on_network_event``."""
        return self.on_network_event(t)

    def run(self, duration: float) -> List[RepartitionEvent]:
        """Control-only run: replay the trace's network events with no
        request traffic.  For a measured request stream, attach to a
        ``ServingEngine`` and call ``engine.run`` instead."""
        for t in self.network_events(duration):
            self.on_network_event(t)
        self.mgr.pool.drain()       # settle trailing background builds
        return self.events

    def close(self) -> None:
        """Settle background work and stop the pool's build worker."""
        self.mgr.pool.close()
