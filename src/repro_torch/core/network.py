"""Network emulation between the edge and cloud stages.

The paper shapes traffic with Linux ``tc`` (20 Mbps <-> 5 Mbps, 20 ms RTT,
section IV-A).  Here the link is a model: a ``NetworkModel`` prices an
activation transfer, a ``BandwidthTrace`` scripts speed changes over
(virtual) time, and a ``NetworkMonitor`` detects changes — the paper's
repartition trigger (section II-B: network variation is THE valid scenario;
CPU/memory stress is not).

In the multi-pod TPU mapping the same classes describe the inter-pod link
(ICI/DCN); only the constants change (see hardware.py).
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.concurrency import RANK_BREAKER, guarded_by, make_lock


@dataclass
class NetworkModel:
    bandwidth_mbps: float
    latency_ms: float = 20.0

    def transfer_time(self, nbytes: int) -> float:
        """Seconds to move nbytes edge->cloud (latency + serialisation).

        A dead link (``bandwidth <= 0``) prices as ``math.inf`` — a
        representable outage the serving path can branch on, not a
        ZeroDivisionError."""
        if self.bandwidth_mbps <= 0.0:
            return math.inf
        return self.latency_ms / 1e3 + nbytes * 8 / (self.bandwidth_mbps * 1e6)


@dataclass
class BandwidthTrace:
    """Scripted (time_s, mbps) steps; bandwidth holds until the next step."""
    steps: Sequence[Tuple[float, float]]   # sorted by time
    latency_ms: float = 20.0

    def at(self, t: float) -> NetworkModel:
        times = [s[0] for s in self.steps]
        i = bisect.bisect_right(times, t) - 1
        i = max(i, 0)
        return NetworkModel(self.steps[i][1], self.latency_ms)

    def change_points(self) -> List[float]:
        return [t for t, _ in self.steps[1:]]


PAPER_TRACE = BandwidthTrace(steps=[(0.0, 20.0), (30.0, 5.0), (60.0, 20.0)])


@dataclass
class NetworkMonitor:
    """Detects bandwidth change beyond a relative threshold.

    The paper repartitions on every observed change; ``hysteresis`` > 0 is a
    beyond-paper extension (its section VI lists repartition-frequency control
    as future work).
    """
    trace: BandwidthTrace
    rel_threshold: float = 0.10
    hysteresis_s: float = 0.0
    _last_bw: Optional[float] = None
    _last_change_t: float = -1e9

    def sample(self, t: float) -> NetworkModel:
        """The link state at ``t`` without change detection (observe ticks)."""
        return self.trace.at(t)

    def poll(self, t: float) -> Optional[NetworkModel]:
        """Returns the new NetworkModel if a significant change happened."""
        net = self.trace.at(t)
        if self._last_bw is None:
            self._last_bw = net.bandwidth_mbps
            return None
        delta = abs(net.bandwidth_mbps - self._last_bw)
        if self._last_bw == 0.0:
            # a trace step to 0 Mbps is a link outage; any recovery from it
            # is an infinitely large relative change, not a crash
            rel = float("inf") if delta else 0.0
        else:
            rel = delta / self._last_bw
        if rel > self.rel_threshold and (t - self._last_change_t) >= self.hysteresis_s:
            self._last_bw = net.bandwidth_mbps
            self._last_change_t = t
            return net
        return None


@guarded_by("_lock", "_open", "_bad", "_good", "opened_at", rank=RANK_BREAKER)
class CircuitBreaker:
    """Consecutive-sample circuit breaker on the cloud link.

    ``record(t, bw)`` feeds each observed bandwidth sample; after
    ``open_after`` consecutive samples at/below ``outage_bw_mbps`` the
    breaker *opens* (sustained outage — the engine should enter
    edge-only degraded mode), and after ``close_after`` consecutive
    healthy samples it *closes* again.  Edge-triggered: ``record``
    returns ``"open"``/``"close"`` exactly once per transition, else
    ``None``.  Thread-safe; the lock is a leaf (``RANK_BREAKER``) never
    held across any other acquisition.
    """

    def __init__(self, outage_bw_mbps: float = 0.5, open_after: int = 1,
                 close_after: int = 1):
        self.outage_bw_mbps = float(outage_bw_mbps)
        self.open_after = max(1, int(open_after))
        self.close_after = max(1, int(close_after))
        self._lock = make_lock("circuit-breaker", RANK_BREAKER)
        self._open = False
        self._bad = 0               # consecutive outage samples
        self._good = 0              # consecutive healthy samples
        self.opened_at: Optional[float] = None

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def record(self, t: float, bandwidth_mbps: float) -> Optional[str]:
        with self._lock:
            if bandwidth_mbps <= self.outage_bw_mbps:
                self._bad += 1
                self._good = 0
                if not self._open and self._bad >= self.open_after:
                    self._open = True
                    self.opened_at = t
                    return "open"
            else:
                self._good += 1
                self._bad = 0
                if self._open and self._good >= self.close_after:
                    self._open = False
                    self.opened_at = None
                    return "close"
        return None
