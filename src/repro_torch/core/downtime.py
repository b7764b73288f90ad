"""Analytic frame-drop model — the cross-check for measured timelines.

The port's copy of ``repro/core/downtime.py``, logic unchanged.

Since the ServingEngine landed (``repro_torch.serving.engine``), downtime and
drop rates are **measured** on a live request stream and recorded in a
``ServiceTimeline``; this module's closed-form simulator is kept as an
independent prediction to cross-check those measurements against
(``crosscheck_timeline``) and for quick what-if sweeps (`sweep_fps`)
without running a stream.

The simulator replays a single repartition window analytically:
* per-frame edge occupancy = measured stage-edge wall time (scaled to the
  edge spec) — frames pipeline, so the edge is the admission bottleneck;
* repartition windows = measured SwitchReport downtimes.

Drop rules (matching the paper's semantics):
* Pause-and-Resume window: the edge is fully paused — every frame arriving
  in the window is dropped ("no frames sent from the device will be
  processed").
* Dynamic-Switching window: the OLD pipeline keeps serving at its
  (now suboptimal) latency — a frame is dropped only if it arrives while
  the edge stage is busy (a camera keeps only the latest frame).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class SimResult:
    fps: float
    window: float           # downtime window length (s)
    arrived: int
    dropped: int
    served: int

    @property
    def drop_rate(self) -> float:
        return self.dropped / self.arrived if self.arrived else 0.0


def simulate_window(*, fps: float, window: float, service_time: float,
                    full_outage: bool, horizon: Optional[float] = None
                    ) -> SimResult:
    """Simulate frames arriving at `fps` across a repartition window.

    The window starts at t=0; simulation runs to `horizon` (default: window).
    `service_time` = edge-stage occupancy per frame of the pipeline serving
    DURING the window (the old pipeline for dynamic switching).
    """
    horizon = horizon if horizon is not None else max(window, 1e-9)
    dt = 1.0 / fps
    t = 0.0
    busy_until = 0.0
    arrived = dropped = served = 0
    while t < horizon:
        arrived += 1
        in_window = t < window
        if full_outage and in_window:
            dropped += 1
        elif t < busy_until:
            dropped += 1            # camera keeps only the latest frame
        else:
            served += 1
            busy_until = t + service_time
        t += dt
    return SimResult(fps, window, arrived, dropped, served)


def sweep_fps(fps_list, *, window, service_time, full_outage
              ) -> List[SimResult]:
    return [simulate_window(fps=f, window=window, service_time=service_time,
                            full_outage=full_outage) for f in fps_list]


def crosscheck_timeline(timeline, *, fps: float, service_time: float
                        ) -> List[Dict[str, float]]:
    """Compare a measured ``ServiceTimeline`` against this simulator.

    For every switch window the timeline recorded, predict arrivals and
    drops analytically (``simulate_window`` over the *measured* window
    length) and set them next to what the stream actually measured.  The
    two are independent paths to the same number — the engine counts real
    admitted requests, the simulator integrates a closed-form arrival
    process — so agreement within a request or two of boundary slack
    validates both.  ``timeline`` is duck-typed (needs ``windows``,
    ``arrivals_in``, ``drops_in``).
    """
    out: List[Dict[str, float]] = []
    for w in timeline.windows:
        sim = simulate_window(fps=fps, window=w.duration,
                              service_time=service_time,
                              full_outage=w.full_outage,
                              horizon=max(w.duration, 1e-9))
        arrived = len(timeline.arrivals_in(w.t_start, w.t_end))
        dropped = len(timeline.drops_in(w.t_start, w.t_end))
        out.append({
            "strategy": w.strategy,
            "window_s": w.duration,
            "full_outage": w.full_outage,
            "measured_arrived": arrived,
            "measured_dropped": dropped,
            "measured_drop_rate": dropped / arrived if arrived else 0.0,
            "predicted_arrived": sim.arrived,
            "predicted_dropped": sim.dropped,
            "predicted_drop_rate": sim.drop_rate,
        })
    return out
