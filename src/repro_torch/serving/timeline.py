"""ServiceTimeline: the measured record of a request stream.

The port's copy of ``repro/serving/timeline.py``, logic unchanged.

Every request the ServingEngine admits leaves a ``RequestRecord`` (admit /
serve / drop, with stage timings and the split that served it), and every
repartition leaves a ``SwitchWindow`` stamped with the *measured* interval
during which the stream was impacted.  All service metrics — downtime,
drop rate, latency percentiles — are **derived from these records**, not
from analytic formulas; ``core/downtime.simulate_window`` survives only as
a cross-check against this measured timeline (see
``core.downtime.crosscheck_timeline``).
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RequestRecord:
    """One request's life on the stream clock."""
    rid: int
    t_arrival: float
    t_start: Optional[float] = None     # edge stage entry
    t_done: Optional[float] = None      # cloud stage exit
    split: Optional[int] = None         # split of the pipeline that served it
    drop_reason: Optional[str] = None   # "outage" | "busy" | "queue_full"
    drained_in_switch: bool = False     # completed on the old pipeline while
                                        # a repartition replaced it
    client: Optional[str] = None        # ClientStream id (None: the single
                                        # anonymous source)
    degraded: bool = False              # served in edge-only degraded mode
                                        # (cloud link down, breaker open)
    sessions: Optional[tuple] = None    # live decode-session ids sharing the
                                        # slot pool when this request was
                                        # served (None: stateless pipeline)

    @property
    def served(self) -> bool:
        return self.t_done is not None

    @property
    def dropped(self) -> bool:
        return self.drop_reason is not None

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_arrival


@dataclass
class SwitchWindow:
    """Measured stream-clock interval one repartition impacted the stream."""
    t_start: float
    t_end: float
    strategy: str
    full_outage: bool
    old_split: Optional[int]
    new_split: int
    drained: int = 0                    # in-flight requests drained on the
                                        # old pipeline during the switch
    analytic_downtime: float = 0.0      # SwitchReport.downtime, for the
                                        # measured-vs-analytic comparison
    t_handoff: float = 0.0              # executed state hand-off seconds
                                        # inside this window (stateful)
    handoff_mode: str = ""              # 'transfer' | 'recompute' | ''
    aborted: bool = False               # watchdog timed the switch out;
                                        # the engine rolled back
    t_reshard: float = 0.0              # on-stream mesh-reshard seconds
                                        # inside this window
    mesh_change: bool = False           # the switch changed the cloud
                                        # mesh shape

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclass
class DegradedWindow:
    """Stream interval served edge-only because the cloud link died.

    Opened when the circuit breaker trips, closed after the engine has
    repartitioned *back* on recovery — so ``duration`` is the
    mean-time-to-recovery contribution including the restore switch.
    """
    t_start: float
    split: int                          # edge-only split served during it
    reason: str = "link_outage"
    t_end: Optional[float] = None       # None: still open at end of run

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    @property
    def duration(self) -> Optional[float]:
        return None if self.t_end is None else self.t_end - self.t_start


class ServiceTimeline:
    """Accumulates the stream's records and derives service metrics."""

    def __init__(self):
        self.records: List[RequestRecord] = []
        self.windows: List[SwitchWindow] = []
        self.degraded: List[DegradedWindow] = []
        self.t_end: Optional[float] = None      # stamped by the engine at
                                                # end of run
        # sorted side-indices so the rolling-window metrics the SLO policy
        # polls every observe tick cost O(log n + window), not a full
        # rescan of the stream (arrivals already come in stream order, so
        # the insorts below are effectively appends)
        self._arrival_ts: List[float] = []
        self._completions: List[tuple] = []     # (t_done, latency), sorted

    # -- recording (engine-facing) ----------------------------------------
    def admit(self, rid: int, t: float,
              client: Optional[str] = None) -> RequestRecord:
        rec = RequestRecord(rid, t, client=client)
        self.records.append(rec)
        bisect.insort(self._arrival_ts, t)
        return rec

    def drop(self, rec: RequestRecord, reason: str) -> None:
        rec.drop_reason = reason

    def serve(self, rec: RequestRecord, *, t_start: float, t_done: float,
              split: int, degraded: bool = False,
              sessions: Optional[tuple] = None) -> None:
        rec.t_start, rec.t_done, rec.split = t_start, t_done, split
        rec.degraded = degraded
        rec.sessions = sessions
        bisect.insort(self._completions, (t_done, t_done - rec.t_arrival))

    def record_switch(self, window: SwitchWindow) -> None:
        self.windows.append(window)

    def enter_degraded(self, t: float, *, split: int,
                       reason: str = "link_outage") -> DegradedWindow:
        w = DegradedWindow(t, split, reason)
        self.degraded.append(w)
        return w

    def exit_degraded(self, t: float) -> None:
        for w in reversed(self.degraded):
            if w.t_end is None:
                w.t_end = t
                return

    def finish(self, t: float) -> None:
        self.t_end = t
        for w in self.degraded:
            if w.t_end is None:
                w.t_end = t             # still dark at end of run

    # -- derived metrics ---------------------------------------------------
    @property
    def arrived(self) -> int:
        return len(self.records)

    @property
    def served_count(self) -> int:
        return sum(1 for r in self.records if r.served)

    @property
    def dropped_count(self) -> int:
        return sum(1 for r in self.records if r.dropped)

    @property
    def drop_rate(self) -> float:
        return self.dropped_count / self.arrived if self.arrived else 0.0

    def latencies(self, client: Optional[str] = None) -> np.ndarray:
        return np.asarray([r.latency for r in self.records if r.served
                           and (client is None or r.client == client)],
                          dtype=np.float64)

    def percentile(self, p: float, client: Optional[str] = None) -> float:
        lat = self.latencies(client)
        return float(np.percentile(lat, p)) if lat.size else float("nan")

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def downtime(self) -> float:
        """Total measured stream time impacted by switches (Σ windows)."""
        return sum(w.duration for w in self.windows)

    def downtime_by_strategy(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for w in self.windows:
            out[w.strategy] = out.get(w.strategy, 0.0) + w.duration
        return out

    def arrivals_in(self, t0: float, t1: float) -> List[RequestRecord]:
        return [r for r in self.records if t0 <= r.t_arrival < t1]

    def drops_in(self, t0: float, t1: float,
                 reason: Optional[str] = None) -> List[RequestRecord]:
        return [r for r in self.arrivals_in(t0, t1) if r.dropped
                and (reason is None or r.drop_reason == reason)]

    def degraded_seconds(self) -> float:
        """Total stream time spent in edge-only degraded mode (open
        windows count up to ``t_end``/their own end)."""
        return sum(w.duration for w in self.degraded if w.duration is not None)

    def mttr(self) -> Optional[float]:
        """Mean time to recovery: mean duration of *closed* degraded
        windows (open ones never recovered, so they don't average in).
        None when the link never died."""
        ds = [w.duration for w in self.degraded
              if w.closed and w.duration is not None]
        return sum(ds) / len(ds) if ds else None

    def switch_drops(self, wake: float = 0.0) -> int:
        """Drops attributable to switching: arrivals inside a switch
        window or its wake (within ``wake`` seconds after it) — as
        opposed to steady-state noise spikes elsewhere in the stream."""
        return sum(len(self.drops_in(w.t_start, w.t_end + wake))
                   for w in self.windows)

    # -- rolling metrics (the SLO-aware policy's inputs) -------------------
    def rolling_p99(self, t: float, window: float) -> float:
        """p99 latency over requests *completed* in ``(t - window, t]`` —
        the live signal an SLO-aware repartition policy watches.  NaN when
        nothing completed in the window."""
        lo = bisect.bisect_right(self._completions, (t - window, float("inf")))
        hi = bisect.bisect_right(self._completions, (t, float("inf")))
        if lo == hi:
            return float("nan")
        lat = np.asarray([l for _, l in self._completions[lo:hi]],
                         dtype=np.float64)
        return float(np.percentile(lat, 99.0))

    def rolling_arrival_rate(self, t: float, window: float) -> float:
        """Arrivals/second over ``(t - window, t]`` (served or not)."""
        if window <= 0:
            return 0.0
        lo = bisect.bisect_right(self._arrival_ts, t - window)
        hi = bisect.bisect_right(self._arrival_ts, t)
        return (hi - lo) / window

    # -- per-client attribution --------------------------------------------
    def clients(self) -> List[str]:
        """Client ids in first-appearance order (excludes the anonymous
        single-source stream)."""
        out: List[str] = []
        for r in self.records:
            if r.client is not None and r.client not in out:
                out.append(r.client)
        return out

    def client_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-client admission fairness view: arrived/served/dropped,
        drop rate and latency percentiles for every client (one pass)."""
        groups: Dict[str, List[RequestRecord]] = {}
        for r in self.records:
            if r.client is not None:
                groups.setdefault(r.client, []).append(r)
        out: Dict[str, Dict[str, float]] = {}
        for cid, recs in groups.items():
            lat = np.asarray([r.latency for r in recs if r.served],
                             dtype=np.float64)
            dropped = sum(1 for r in recs if r.dropped)
            out[cid] = {
                "arrived": len(recs),
                "served": int(lat.size),
                "dropped": dropped,
                "drop_rate": round(dropped / len(recs), 4),
                # None, not NaN: these rows land in JSONL grids, and bare
                # NaN is invalid JSON for strict parsers
                "p50_ms": round(float(np.percentile(lat, 50.0)) * 1e3, 3)
                if lat.size else None,
                "p99_ms": round(float(np.percentile(lat, 99.0)) * 1e3, 3)
                if lat.size else None,
            }
        return out

    def session_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-decode-session attribution: how many served requests each
        slot-pool session id was live for, and the latency percentiles of
        those requests.  Empty for stateless pipelines (no slot pool)."""
        groups: Dict[str, List[RequestRecord]] = {}
        for r in self.records:
            for sid in (r.sessions or ()):
                groups.setdefault(sid, []).append(r)
        out: Dict[str, Dict[str, float]] = {}
        for sid, recs in groups.items():
            lat = np.asarray([r.latency for r in recs if r.served],
                             dtype=np.float64)
            out[sid] = {
                "served": int(lat.size),
                # None, not NaN: same JSONL-strictness rule as
                # client_summary above
                "p50_ms": round(float(np.percentile(lat, 50.0)) * 1e3, 3)
                if lat.size else None,
                "p99_ms": round(float(np.percentile(lat, 99.0)) * 1e3, 3)
                if lat.size else None,
            }
        return out

    def outage_bounds(self) -> Optional[tuple]:
        """Derive the outage interval purely from the request stream: the
        arrival span of requests dropped for "outage".  Cross-checks the
        engine-stamped window without trusting it."""
        ts = [r.t_arrival for r in self.records if r.drop_reason == "outage"]
        return (min(ts), max(ts)) if ts else None

    def summary(self) -> Dict[str, float]:
        return {
            "arrived": self.arrived,
            "served": self.served_count,
            "dropped": self.dropped_count,
            "drop_rate": round(self.drop_rate, 4),
            "downtime_ms": round(self.downtime() * 1e3, 3),
            "n_switches": len(self.windows),
            "p50_ms": round(self.p50 * 1e3, 3),
            "p99_ms": round(self.p99 * 1e3, 3),
            "drained_in_switch": sum(1 for r in self.records
                                     if r.drained_in_switch),
            "n_clients": len(self.clients()),
            "aborted_switches": sum(1 for w in self.windows if w.aborted),
            "degraded_s": round(self.degraded_seconds(), 6),
        }

    def serialize(self) -> str:
        """Canonical JSON of every record and switch window.

        Two timelines from identically-seeded deterministic runs (virtual
        clock, deterministic service times) compare *byte*-identical via
        this string — the workload-determinism contract the tier-1 tests
        enforce."""
        return json.dumps({
            "t_end": self.t_end,
            "records": [[r.rid, r.client, r.t_arrival, r.t_start, r.t_done,
                         r.split, r.drop_reason, r.drained_in_switch,
                         r.degraded,
                         None if r.sessions is None else list(r.sessions)]
                        for r in self.records],
            "windows": [[w.t_start, w.t_end, w.strategy, w.full_outage,
                         w.old_split, w.new_split, w.drained, w.aborted]
                        for w in self.windows],
            "degraded": [[w.t_start, w.t_end, w.split, w.reason]
                         for w in self.degraded],
        }, sort_keys=True, separators=(",", ":"))
