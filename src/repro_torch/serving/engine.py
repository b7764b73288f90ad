"""ServingEngine: measure downtime on a live request stream.

The port's copy of ``repro/serving/engine.py``, logic unchanged but for
``_smoke``, which builds the port's reduced qwen2.5-3b on ``device`` from
seeded torch generators.

The paper's headline numbers (6 s pause-and-resume vs sub-second dynamic
switching) are measured on a stream of inference requests hitting the
edge; this engine reproduces that methodology instead of deriving
downtime analytically from ``SwitchReport`` components.

Lifecycle (admission -> stages -> timeline -> switch):

* **admission** — requests arrive on the stream clock and pass a bounded
  admission queue (``queue_depth=0`` is the paper's camera: a frame that
  finds the edge stage busy is dropped, only the latest frame is kept);
* **stages** — two stage workers model the paper's pipelined testbed: the
  edge stage is occupied for the request's measured ``t_edge``, the cloud
  stage for ``t_cloud``, with the priced transfer between them, so a new
  frame enters the edge while the previous one is still in the cloud.
  Each admitted request really runs through the active
  ``EdgeCloudPipeline`` (real compiled stages) and its *measured*
  ``RequestTiming`` is what occupies the workers on the stream clock;
* **timeline** — every admit/serve/drop lands in a ``ServiceTimeline``;
  downtime, drop rate and p50/p99 latency are derived from those records;
* **switch** — repartitions happen while requests are in flight.  The
  switch really executes (real compile / checkpoint reload) on the
  serving loop; its measured wall duration is charged to the stream
  clock as the blocking window.  In-flight requests drain on the old
  pipeline (the paper's "incoming requests are switched to the new
  pipeline"); a ``full_outage`` switch (Pause-and-Resume) additionally
  drops every arrival inside the window.

Clock modes: ``VirtualClock`` (the default) makes runs deterministic —
virtual seconds are free, measured costs are replayed onto the stream —
and is the measurement mode the benchmarks and tier-1 tests use.
``WallClock`` paces arrivals in real time but service still executes
inline on the loop, so a stream heavier than the host sustains falls
behind its schedule (arrivals then replay as fast as possible); use it
for demos and soak runs, not for measured comparisons.

Network changes arrive as stream-clock events: either scripted directly
(``schedule_switch``) or through an attached ``NeukonfigController``,
whose ``BandwidthTrace`` change points become engine events
(``controller.network_events``).

Multi-client mode (``run(clients=[ClientStream, ...], duration=...)``):
each client generates its own seeded arrival stream
(``repro_torch.serving.workload``) and owns a *bounded per-client admission
queue* (``queue_depth=0`` keeps the camera rule per client).  The edge
stage is the shared bottleneck: when it frees, a **dispatch event** picks
the next waiting client under the configured admission fairness —
``round_robin`` (each non-empty queue served once per cycle, so no client
starves while another's queue has slack) or ``weighted`` (smooth weighted
round-robin over ``ClientStream.weight``).  Every ``RequestRecord``
carries its client id, so the timeline derives per-client drop rates and
latency percentiles (``ServiceTimeline.client_summary``).

Multi-session slot pools: when the pool carries a
``repro_torch.serving.sessions.SessionManager`` (built via
``make_session_manager``), every served request is stamped with the live
session ids (``ServiceTimeline.session_summary``), and
``schedule_admit`` scripts mid-flight admissions — a new session prefills
into a masked slot on the serving loop, charged to the stream clock,
while the other slots' decode state is untouched.

Which numbers are measured vs simulated: everything the engine reports is
measured (stage walls, switch walls, per-request stream timestamps).  The
stand-alone ``core/downtime.simulate_window`` remains as an analytic
cross-check only (``core.downtime.crosscheck_timeline``).

Smoke run: ``PYTHONPATH=src python -m repro_torch.serving --smoke``.
"""
from __future__ import annotations

import heapq
import itertools
import math
import threading
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.executor import BuildHandle
from repro_torch.core.network import NetworkModel
from repro_torch.core.pool import SwitchAbortedWarning
from repro_torch.core.strategies import SwitchReport, apply_handoff
from repro_torch.serving.clock import Clock, VirtualClock, WallClock
from repro_torch.serving.timeline import (RequestRecord, ServiceTimeline,
                                    SwitchWindow)
from repro_torch.serving.workload import ClientStream

# event priorities at equal timestamps: control plane before traffic, and
# the freed edge picks from the queues before a same-instant arrival
_PRIO_NET, _PRIO_CMD, _PRIO_OBSERVE, _PRIO_DISPATCH, _PRIO_REQ = range(5)


def request_stream(inputs, fps: float, duration: float, start: float = 0.0
                   ) -> Iterable[Tuple[float, dict]]:
    """Fixed-rate arrivals (the paper's camera): (t_arrival, inputs)."""
    dt = 1.0 / fps
    t, i = start, 0
    while t < start + duration - 1e-12:
        yield (t, inputs)
        i += 1
        t = start + i * dt


@dataclass
class StageWorker:
    """One pipelined stage (edge or cloud) on the stream clock."""
    name: str
    busy_until: float = 0.0
    busy_total: float = 0.0
    served: int = 0

    def occupy(self, start: float, dt: float) -> float:
        """Occupy the worker for ``dt`` from ``start``; returns end time."""
        end = start + dt
        self.busy_until = max(self.busy_until, end)
        self.busy_total += dt
        self.served += 1
        return end


@dataclass
class _ClientState:
    """One client's live admission state inside the engine."""
    stream: ClientStream
    queue: deque = field(default_factory=deque)   # waiting (record, inputs)
    credit: float = 0.0                           # smooth-WRR credit


class ServingEngine:
    """Event loop joining an admission queue, the stage workers, the
    timeline and the repartitioning control plane."""

    def __init__(self, mgr, *, clock: Optional[Clock] = None,
                 controller=None, timeline: Optional[ServiceTimeline] = None,
                 queue_depth: int = 0, overlap: bool = False,
                 observe_dt: Optional[float] = None, warmup: bool = True,
                 fairness: str = "round_robin",
                 switch_timeout_s: Optional[float] = None,
                 breaker=None, fault_plan=None,
                 degraded_strategy="switch_b2"):
        self.mgr = mgr
        self.pool = mgr.pool
        # -- robustness knobs (all default off: tier-1 behaviour unchanged)
        # watchdog: a switch() that hasn't returned after this many wall
        # seconds is fenced off and rolled back instead of wedging the loop
        self.switch_timeout_s = switch_timeout_s
        # cloud-link circuit breaker (repro_torch.core.network.CircuitBreaker):
        # opens on sustained outage -> edge-only degraded mode
        self.breaker = breaker
        # chaos valve (repro_torch.core.faults.FaultPlan): per-request timing
        # perturbations are the only hook the engine itself consults
        self.fault_plan = fault_plan
        # strategy spec used for the enter/exit degraded-mode repartitions
        self.degraded_strategy = degraded_strategy
        self._degraded = False
        self._pre_degraded_split: Optional[int] = None
        self._scheduled_net: List[Tuple[float, float, float]] = []
        self._scheduled_admits: List[Tuple[float, object, object]] = []
        self.clock = clock if clock is not None else VirtualClock()
        self.timeline = timeline if timeline is not None else ServiceTimeline()
        self.queue_depth = int(queue_depth)
        if fairness not in ("round_robin", "weighted"):
            raise ValueError(f"unknown fairness {fairness!r} "
                             f"(round_robin | weighted)")
        self.fairness = fairness
        # overlap=False models the inter-switch serving gap: background
        # builds settle (off-stream) before the next switch.  overlap=True
        # leaves builds in flight — switches may then wait-hit them, which
        # is the overlapped path the executor tests exercise.
        self.overlap = overlap
        self.observe_dt = observe_dt
        # a deployment has served long before the measured window starts:
        # absorb the active pipeline's first-execution spike off-stream
        self.warmup = warmup
        self.edge = StageWorker("edge")
        self.cloud = StageWorker("cloud")
        self.reports: List = []
        self.controller = controller
        if controller is not None:
            controller.attach(self)
        self._scheduled: List[Tuple[float, object, int, Optional[float]]] = []
        self._outage_until = float("-inf")
        self._blocked_until = float("-inf")
        self._inflight: List[Tuple[float, RequestRecord]] = []
        self._pending_starts: deque = deque()
        self._rid = itertools.count()
        # multi-client admission state (populated by run(clients=...))
        self._clients: Dict[str, _ClientState] = {}
        self._queued_total = 0
        self._dispatch_armed = False
        self._rr_idx = 0
        self._heap: List = []
        self._seq = itertools.count()

    # -- control plane ------------------------------------------------------
    def schedule_switch(self, t: float, strategy, new_split: int, *,
                        bandwidth_mbps: Optional[float] = None) -> None:
        """Script a repartition at stream time ``t`` (optionally changing
        the link bandwidth first) — the controller-less benchmark path."""
        self._scheduled.append((t, strategy, new_split, bandwidth_mbps))

    def schedule_admit(self, t: float, prompt, sid=None) -> None:
        """Script a mid-flight session admission at stream time ``t``: the
        pool's ``SessionManager`` prefills ``prompt`` into a free (or
        preempted) slot while the other sessions keep decoding.  Requires
        a stateful pool built with a slot pool
        (``repro_torch.serving.sessions.make_session_manager``)."""
        self._scheduled_admits.append((t, prompt, sid))

    def execute_admit(self, prompt, sid=None) -> str:
        """Admit one session now, measured on the stream: the admission
        prefill's wall duration is charged to the stream clock (it runs on
        the serving loop, like a switch — but per-slot, so the live slots'
        decode state is never touched)."""
        sess = getattr(self.pool, "session", None)
        if sess is None or not hasattr(sess, "admit"):
            raise RuntimeError("scheduled admission needs a slot-pool "
                               "session (make_session_manager)")
        with self.clock.measure():
            out = sess.admit(prompt, sid=sid)
        self._blocked_until = max(self._blocked_until, self.clock.now())
        return out

    def execute_switch(self, strategy, new_split: int):
        """Run one repartition on the serving loop, measured on the stream.

        The strategy call really executes; its wall duration blocks the
        stream clock.  In-flight requests (admitted before the switch,
        completing after it) drain on the old pipeline.
        """
        strategy = self.mgr.get_strategy(strategy)
        if not self.overlap:
            # the gap since the previous switch was stream-seconds long;
            # background builds finished during it (not charged to the
            # switch window).  Under a watchdog the settle is bounded:
            # a wedged background build must not block the next switch.
            self.pool.drain(timeout=self.switch_timeout_s)
        t_sw = self.clock.now()
        old = self.pool.snapshot_active()
        paused_before = getattr(self.pool, "pause_epoch", 0)
        self._prune_inflight(t_sw)          # whatever remains is in flight
        inflight = [rec for _, rec in self._inflight]
        with self.clock.measure():
            report = self._run_switch(strategy, new_split, old, paused_before)
        # stateful pipelines: the hand-off's measured wall is already in
        # the charge above (it ran on this thread inside switch()); the
        # priced link time for the serialized state never consumed wall,
        # so it blocks the stream via sleep_until — a real sleep under
        # WallClock (charge would be a no-op there), the same advance as
        # charge under VirtualClock
        handoff = apply_handoff(self.pool, report)
        if handoff is not None and handoff.t_network > 0:
            self.clock.sleep_until(self.clock.now() + handoff.t_network)
        t_end = self.clock.now()
        self._blocked_until = max(self._blocked_until, t_end)
        if report.full_outage:
            self._outage_until = max(self._outage_until, t_end)
        for rec in inflight:
            rec.drained_in_switch = True
        self.timeline.record_switch(SwitchWindow(
            t_start=t_sw, t_end=t_end, strategy=report.strategy,
            full_outage=report.full_outage,
            old_split=old.split if old is not None else None,
            new_split=report.new_split, drained=len(inflight),
            analytic_downtime=report.downtime,
            t_handoff=report.t_handoff,
            handoff_mode=report.handoff_mode,
            aborted=report.aborted,
            t_reshard=report.t_reshard,
            mesh_change=report.mesh_change))
        self.reports.append(report)
        return report

    def _run_switch(self, strategy, new_split: int, old,
                    paused_before: int) -> SwitchReport:
        """Run ``strategy.switch`` — directly, or under the watchdog.

        With ``switch_timeout_s`` set the switch runs on a sacrificial
        thread; on timeout that thread is *fenced* at the pool (any
        further activate/pause from it raises ``SwitchAborted``) and an
        ``aborted`` report is returned after rolling back, so a stalled
        build wedges one thread, never the stream.  Fencing takes the
        pool lock, so it linearizes against an in-flight pointer swap —
        the post-fence grace re-check catches a switch that completed in
        the gap and treats it as a success.
        """
        if self.switch_timeout_s is None:
            return strategy.switch(self.pool, new_split)
        handle = BuildHandle(lambda: strategy.switch(self.pool, new_split),
                             key=("switch", new_split))
        th = threading.Thread(target=handle._run, name="nk-switch",
                              daemon=True)
        th.start()
        if not handle.wait(self.switch_timeout_s):
            self.pool.fence_thread(th)
            if not (handle.wait(0.05) and handle.error is None):
                return self._aborted_report(
                    strategy, new_split, old, paused_before,
                    f"watchdog timeout after {self.switch_timeout_s}s")
            self.pool.unfence_thread(th)    # completed in the fence gap
        if handle.error is not None:
            return self._aborted_report(
                strategy, new_split, old, paused_before,
                f"switch raised: {handle.error!r}")
        return handle.result

    def _aborted_report(self, strategy, new_split: int, old,
                        paused_before: int, why: str) -> SwitchReport:
        """Roll back an abandoned switch and synthesize its report.

        ``full_outage`` is honest about what the stream saw: True when
        the attempt paused serving before it was fenced (pause epoch
        advanced — arrivals inside this window were dropped) or left no
        active pipeline (then the old one is re-activated)."""
        warnings.warn(f"switch to split {new_split} aborted ({why}); "
                      f"service continues on the previous pipeline",
                      SwitchAbortedWarning)
        went_dark = getattr(self.pool, "pause_epoch", 0) > paused_before
        full_outage = went_dark
        if self.pool.snapshot_active() is None:
            full_outage = True
            if old is not None:
                self.pool.try_activate(old.key)   # rollback
        spec = getattr(strategy, "name", None) or str(strategy)
        return SwitchReport(spec, old.split if old is not None else -1,
                            new_split, downtime=0.0,
                            full_outage=full_outage, aborted=True, note=why)

    def set_network(self, net: NetworkModel) -> None:
        self.mgr.set_network(net)
        self.note_network(self.clock.now(), net)

    def schedule_network(self, t: float, bandwidth_mbps: float,
                         latency_ms: float = 20.0) -> None:
        """Script a link change at stream time ``t`` — the controller-less
        path for driving outages through the breaker (chaos benchmarks)."""
        self._scheduled_net.append((t, bandwidth_mbps, latency_ms))

    # -- degraded mode (cloud link dead -> edge-only) -----------------------
    def note_network(self, t: float, net: NetworkModel) -> bool:
        """Feed one observed link sample to the circuit breaker and act on
        its transitions: ``open`` -> repartition to the deepest edge-only
        split that fits the memory budget; ``close`` -> repartition back.
        Returns True when a transition was handled this call (controllers
        then skip their own repartition logic for this sample)."""
        if self.breaker is None:
            return False
        edge = self.breaker.record(t, net.bandwidth_mbps)
        if edge == "open" and not self._degraded:
            self._enter_degraded(t)
            return True
        if edge == "close" and self._degraded:
            self._exit_degraded(t)
            return True
        return False

    @property
    def in_degraded(self) -> bool:
        return self._degraded

    def _max_split(self) -> int:
        runner = self.pool.runner
        cfg = getattr(runner, "cfg", None)
        if cfg is not None and getattr(cfg, "num_layers", 0):
            return int(cfg.num_layers)
        return int(runner.max_split)

    def _pick_degraded_split(self) -> int:
        """Deepest edge-only split: the full model when it fits the
        pool's ``mem_budget_bytes``, else the largest-fitting prefix
        (load shedding: serve what fits rather than nothing)."""
        n = self._max_split()
        budget = self.pool.mem_budget_bytes
        bytes_fn = getattr(self.pool.runner, "edge_param_bytes", None)
        if budget is None or bytes_fn is None:
            return n
        for s in range(n, 0, -1):
            if bytes_fn(s) <= budget:
                return s
        return 1

    def _enter_degraded(self, t: float) -> None:
        active = self.pool.snapshot_active()
        self._pre_degraded_split = active.split if active is not None else None
        target = self._pick_degraded_split()
        self._degraded = True
        self.timeline.enter_degraded(t, split=target)
        if active is None or active.split != target:
            self.execute_switch(self.degraded_strategy, target)

    def _exit_degraded(self, t: float) -> None:
        self._degraded = False
        back, self._pre_degraded_split = self._pre_degraded_split, None
        active = self.pool.snapshot_active()
        if back is not None and (active is None or active.split != back):
            self.execute_switch(self.degraded_strategy, back)
        # stamped AFTER the restore repartition: recovery isn't over
        # until the pre-outage partitioning is serving again, so MTTR
        # includes the restore switch
        self.timeline.exit_degraded(self.clock.now())

    # -- traffic plane -------------------------------------------------------
    def _prune_inflight(self, t: float) -> None:
        self._inflight = [(d, r) for d, r in self._inflight if d > t]

    def _execute(self, rec: RequestRecord, inputs,
                 start: float) -> Optional[float]:
        """Really run one request through the active pipeline from
        ``start``; the measured timing occupies the stage workers on the
        stream clock.  Returns the completion time (None: outage drop)."""
        entry = self.pool.snapshot_active()
        if entry is None:
            self.timeline.drop(rec, "outage")
            return None
        _, timing = entry.pipeline.process(inputs)
        if self.fault_plan is not None:
            timing = self.fault_plan.perturb_timing(rec.rid, timing)
        sessions = self._live_sessions()
        if self._degraded:
            # edge-only: the cloud is unreachable, so any residual cloud
            # share executes on the edge hardware (scaled by how much
            # slower it is) and nothing crosses the link
            scale = getattr(entry.pipeline, "edge_scale", 1.0)
            done = self.edge.occupy(start,
                                    timing.t_edge + timing.t_cloud * scale)
            self.timeline.serve(rec, t_start=start, t_done=done,
                                split=entry.split, degraded=True,
                                sessions=sessions)
            self._inflight.append((done, rec))
            return done
        if not math.isfinite(timing.t_transfer):
            # dead link without (or before) an open breaker: the request
            # cannot reach the cloud stage
            self.timeline.drop(rec, "link_down")
            return None
        edge_end = self.edge.occupy(start, timing.t_edge)
        cloud_start = max(edge_end + timing.t_transfer, self.cloud.busy_until)
        done = self.cloud.occupy(cloud_start, timing.t_cloud)
        self.timeline.serve(rec, t_start=start, t_done=done, split=entry.split,
                            sessions=sessions)
        self._inflight.append((done, rec))
        return done

    def _live_sessions(self) -> Optional[tuple]:
        """Live slot-pool session ids, for per-session attribution on the
        timeline (None when the pool carries no multi-session state)."""
        sess = getattr(self.pool, "session", None)
        ids = getattr(sess, "session_ids", None)
        return tuple(ids()) if callable(ids) else None

    def _admit(self, t: float, inputs) -> None:
        rec = self.timeline.admit(next(self._rid), t)
        if t < self._outage_until:
            # Pause-and-Resume semantics: "no frames sent from the device
            # will be processed" while the service is paused
            self.timeline.drop(rec, "outage")
            return
        while self._pending_starts and self._pending_starts[0] <= t:
            self._pending_starts.popleft()
        if self.edge.busy_until > t \
                and len(self._pending_starts) >= self.queue_depth:
            # camera keeps only the latest frame (queue_depth=0), or the
            # bounded admission queue is full.  Only *edge occupancy*
            # drops frames; a dynamic switch briefly holding the serving
            # loop merely delays the start ("incoming requests are
            # switched to the new pipeline") — and since that waiter
            # occupies the edge from the block's end, later arrivals fall
            # under the camera rule as usual.
            self.timeline.drop(rec, "busy" if self.queue_depth == 0
                               else "queue_full")
            return
        start = max(t, self.edge.busy_until, self._blocked_until)
        if self._execute(rec, inputs, start) is not None and start > t:
            self._pending_starts.append(start)

    # -- multi-client admission ---------------------------------------------
    def _edge_free_at(self) -> float:
        return max(self.edge.busy_until, self._blocked_until)

    def _admit_client(self, t: float, cid: str, inputs) -> None:
        """One client's arrival: serve immediately if the edge is idle and
        nothing is queued, otherwise join this client's bounded queue."""
        st = self._clients[cid]
        rec = self.timeline.admit(next(self._rid), t, client=cid)
        if t < self._outage_until:
            self.timeline.drop(rec, "outage")
            return
        if self.edge.busy_until <= t and self._queued_total == 0:
            # only *edge occupancy* queues or drops; a dynamic switch
            # briefly holding the serving loop merely delays the start
            # (the waiter then occupies the edge from the block's end,
            # exactly like the single-source path)
            self._execute(rec, inputs, start=max(t, self._blocked_until))
            return
        depth = st.stream.queue_depth
        if len(st.queue) >= depth:
            # per-client camera rule (depth 0) / bounded queue overflow.
            # Only this client's slack matters: another client's full
            # queue never costs this one its slot.
            self.timeline.drop(rec, "busy" if depth == 0 else "queue_full")
            return
        st.queue.append((rec, inputs))
        self._queued_total += 1
        self._arm_dispatch(max(self._edge_free_at(), t))

    def _arm_dispatch(self, at: float) -> None:
        """Schedule the next edge-free dispatch (at most one armed)."""
        if not self._dispatch_armed:
            self._dispatch_armed = True
            heapq.heappush(self._heap, (at, _PRIO_DISPATCH, next(self._seq),
                                        "dispatch", None))

    def _dispatch(self, t: float) -> None:
        """The edge freed: serve ONE queued request, chosen by the
        fairness policy, then re-arm for the next completion."""
        self._dispatch_armed = False
        if not self._queued_total:
            return
        free = self._edge_free_at()
        if free > t:                    # a switch blocked the stream since
            self._arm_dispatch(free)    # this dispatch was armed
            return
        st = self._pick_client()
        rec, inputs = st.queue.popleft()
        self._queued_total -= 1
        self._execute(rec, inputs, start=t)
        if self._queued_total:
            self._arm_dispatch(max(self._edge_free_at(), t))

    def _pick_client(self) -> _ClientState:
        """Admission fairness over the non-empty client queues."""
        states = list(self._clients.values())
        if self.fairness == "weighted":
            # smooth weighted round-robin over the *backlogged* clients
            # (work-conserving: an empty queue accrues no credit)
            ready = [s for s in states if s.queue]
            total = sum(s.stream.weight for s in ready)
            for s in ready:
                s.credit += s.stream.weight
            best = max(ready, key=lambda s: s.credit)
            best.credit -= total
            return best
        n = len(states)
        for k in range(n):              # round-robin: next non-empty queue
            st = states[(self._rr_idx + k) % n]
            if st.queue:
                self._rr_idx = (self._rr_idx + k + 1) % n
                return st
        raise RuntimeError("dispatch with no queued client")

    # -- event loop ----------------------------------------------------------
    def run(self, source: Optional[Iterable] = None,
            duration: Optional[float] = None,
            clients: Optional[Sequence[ClientStream]] = None
            ) -> ServiceTimeline:
        """Drive the stream to completion; returns the measured timeline.

        ``source`` yields arrivals as ``(t, inputs)`` pairs (see
        ``request_stream``) or objects with ``.t_arrival`` and ``.data``
        (frames such as the reference's ``repro.data.FrameSource`` makes).
        ``clients`` instead admits from N concurrent ``ClientStream``s
        (mutually exclusive with ``source``; requires ``duration`` to bound
        the seeded generators).
        ``duration`` also bounds the control plane when there is no
        traffic (a control-only run).
        """
        if self.warmup:
            entry = self.pool.snapshot_active()
            if entry is not None:
                entry.pipeline.warm(self.pool.sample_inputs)
        heap = self._heap = []
        seq = self._seq = itertools.count()
        t_max = 0.0
        if clients is not None:
            if source is not None:
                raise ValueError("pass source OR clients, not both")
            if duration is None:
                raise ValueError("clients mode needs an explicit duration "
                                 "to bound the seeded arrival generators")
            if self.queue_depth > 0:
                # silently ignoring it would hand a caller porting
                # single-source code camera-rule drop rates they never
                # configured
                raise ValueError(
                    "engine queue_depth is the single-source queue; in "
                    "clients mode set ClientStream.queue_depth per client")
            self._clients = {}
            for cs in clients:
                if cs.client_id in self._clients:
                    raise ValueError(f"duplicate client_id {cs.client_id!r}")
                self._clients[cs.client_id] = _ClientState(cs)
            for cs in clients:
                for t, inputs in cs.arrivals(duration):
                    heapq.heappush(heap, (t, _PRIO_REQ, next(seq), "creq",
                                          (cs.client_id, inputs)))
        elif source is not None:
            for item in source:
                if hasattr(item, "t_arrival"):
                    t, inputs = item.t_arrival, {"tokens": item.data}
                else:
                    t, inputs = item
                heapq.heappush(heap, (t, _PRIO_REQ, next(seq), "req", inputs))
                t_max = max(t_max, t)
        if duration is None:
            duration = t_max
        for t, strat, split, bw in self._scheduled:
            heapq.heappush(heap, (t, _PRIO_CMD, next(seq), "cmd",
                                  (strat, split, bw)))
            duration = max(duration, t)
        for t, bw, lat in self._scheduled_net:
            heapq.heappush(heap, (t, _PRIO_NET, next(seq), "setnet",
                                  (bw, lat)))
            duration = max(duration, t)
        for t, prompt, sid in self._scheduled_admits:
            heapq.heappush(heap, (t, _PRIO_CMD, next(seq), "admit",
                                  (prompt, sid)))
            duration = max(duration, t)
        if self.controller is not None:
            for t in self.controller.network_events(duration):
                heapq.heappush(heap, (t, _PRIO_NET, next(seq), "net", None))
            # dense strategy.observe sampling between change events: default
            # to the controller's poll_dt (the pre-engine polling cadence);
            # observe_dt=0 disables ticks entirely.  Ticks coinciding with
            # a change point are skipped — on_network_event already feeds
            # that sample, and a duplicated point at exactly the change
            # instant would bias trend estimators.
            dt = self.observe_dt if self.observe_dt is not None \
                else getattr(self.controller, "poll_dt", None)
            if dt:
                changes = set(self.controller.network_events(duration))
                k = 1
                while k * dt <= duration:
                    if k * dt not in changes:
                        heapq.heappush(heap, (k * dt, _PRIO_OBSERVE,
                                              next(seq), "observe", None))
                    k += 1
        while heap:
            t, _, _, kind, payload = heapq.heappop(heap)
            self.clock.sleep_until(t)
            self._prune_inflight(t)
            if kind == "req":
                self._admit(t, payload)
            elif kind == "creq":
                self._admit_client(t, *payload)
            elif kind == "dispatch":
                self._dispatch(t)
            elif kind == "net":
                self.controller.on_network_event(t)
            elif kind == "setnet":
                bw, lat = payload
                self.set_network(NetworkModel(bw, latency_ms=lat))
            elif kind == "observe":
                self.controller.observe_tick(t)
            elif kind == "admit":
                prompt, sid = payload
                self.execute_admit(prompt, sid=sid)
            else:                       # scripted switch
                strat, split, bw = payload
                if bw is not None:
                    self.set_network(NetworkModel(bw))
                self.execute_switch(strat, split)
        # settle trailing background builds; bounded under a watchdog so
        # a wedged build can't hang the whole run
        self.pool.drain(timeout=self.switch_timeout_s)
        self.timeline.finish(max(self.clock.now(), duration))
        return self.timeline


def _smoke(device="cuda") -> int:
    """Tiny deterministic engine run for CI: over a full switch cycle the
    measured stream downtime must order pause_resume >> switch_b2 >>
    switch_a (B2 amortises its one-time stage build from the second
    visit to a split onward; pause pays the cold rebuild every time), and
    switch_a must drop nothing.  The reduced qwen2.5-3b runs on
    ``device`` (the card unless the caller asks for another), its weights
    and prompt drawn from seeded generators.

    Each strategy's stream runs three times and is read at its least
    downtime and fewest switch drops: the port's warm build is a millisecond
    forward of the tiny model, not an XLA compile, and a loaded host only
    ever adds to a window (the rule of the port's CPU ordering tests)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), num_layers=2)
    params = T.init_model(cfg, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen).to(dev)
    inputs = {"tokens": toks}
    split_hi = cfg.num_layers
    downs, switch_drops = {}, {}
    for _ in range(3):              # read at the least: see the docstring
        for spec in ("pause_resume", "switch_a", "switch_b2"):
            runner = StageRunner(cfg, params, device=dev)
            mgr = PipelineManager(
                runner, split=1, net=NetworkModel(20.0),
                sample_inputs=inputs, warm_standbys=True,
                standby_split=split_hi if spec == "switch_a" else None)
            # a deployment that has served before has its build worker
            # running: start the thread off-stream, or switch_a's first
            # swap pays its start (up to ~4 ms on a CPU host, longer than
            # the reduced model's whole B2 build)
            mgr.pool.executor.submit(lambda: None).wait()
            eng = ServingEngine(mgr, clock=VirtualClock())
            eng.schedule_switch(2.0, spec, split_hi, bandwidth_mbps=5.0)
            eng.schedule_switch(4.0, spec, 1, bandwidth_mbps=20.0)
            eng.schedule_switch(6.0, spec, split_hi, bandwidth_mbps=5.0)
            tl = eng.run(request_stream(inputs, fps=2.0, duration=8.0))
            downs[spec] = min(downs.get(spec, math.inf), tl.downtime())
            # steady-state noise spikes — one slow forward on a loaded CI
            # host — must not fail the smoke; only switch-attributable
            # drops (window + one arrival of wake) count
            switch_drops[spec] = min(switch_drops.get(spec, math.inf),
                                     tl.switch_drops(wake=1.0))
            print(f"# engine-smoke {spec:12s}: {tl.summary()}")
            mgr.close()
    assert downs["pause_resume"] > downs["switch_b2"] > downs["switch_a"], \
        f"measured ordering violated: {downs}"
    assert switch_drops["switch_a"] == 0, \
        f"switch_a dropped {switch_drops['switch_a']} requests at its switches"
    assert switch_drops["pause_resume"] > 0, \
        "pause_resume outage should drop in-window requests"
    print("# engine-smoke OK: measured pause_resume >> switch_b2 >> switch_a")
    return 0
