"""Pluggable stream clocks for the ServingEngine.

The port's copy of ``repro/serving/clock.py``, logic unchanged.  Its raw
clock sites carry ``# nk: allow[NK02]``: the clock lint exempts the
reference's path only.

The engine is written against one clock interface so the same event loop
serves two modes:

* ``WallClock`` — live mode: ``sleep_until`` really sleeps, and work done
  on the serving thread (a repartition, a stage forward) consumes wall
  time by itself, so ``charge`` is a no-op.
* ``VirtualClock`` — deterministic test/benchmark mode: ``sleep_until``
  jumps, and ``charge(dt)`` replays a *measured* wall-clock cost onto the
  stream clock.  This is how the engine measures downtime on a virtual
  request stream: the switch really runs (real compile, real checkpoint
  reload), its real duration is measured, and that duration blocks the
  stream — nothing is derived from analytic formulas.
"""
from __future__ import annotations

import math
import time

from repro_torch.core import timing

# one nanosecond: the grid stream timestamps are quantised to (below)
TICK_S = 1e-9


def quantize(t: float, tick: float = TICK_S) -> float:
    """Snap a stream time onto the nanosecond grid.

    The workload generators (``repro_torch.serving.workload``) accumulate
    floating-point inter-arrival gaps; quantising every emitted timestamp
    makes seeded runs byte-identical when serialised (and keeps equality
    checks against scheduled event times exact) without measurably moving
    any arrival.
    """
    return round(t / tick) * tick


class Clock:
    """Stream-time source the ServingEngine schedules against."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep_until(self, t: float) -> None:
        """Advance to ``t`` (no-op if ``t`` is already in the past)."""
        raise NotImplementedError

    def charge(self, dt: float) -> None:
        """Account ``dt`` seconds of measured on-thread work (e.g. a
        switch that blocked the serving loop) on the stream clock."""
        raise NotImplementedError

    def measure(self):
        """Context manager timing a block of on-thread work and charging
        its wall cost to this clock on exit (even if the block raises — a
        failed switch still blocked the stream for as long as it ran)::

            with clock.measure() as m:
                strategy.switch(pool, split)
            # m.wall = measured seconds, already charged

        This is the sanctioned serving-path wall-measurement form: NK02
        (``repro.analysis``) forbids raw ``time.perf_counter()`` exactly
        so every measured cost provably lands on the stream clock.
        """
        return timing.measure(charge_to=self)


class WallClock(Clock):
    """Real time: the stream clock is the process monotonic clock."""

    def __init__(self):
        self._t0 = time.monotonic()     # nk: allow[NK02]: the stream clock

    def now(self) -> float:
        return time.monotonic() - self._t0  # nk: allow[NK02]: stream clock

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)

    def charge(self, dt: float) -> None:
        """No-op: on-thread work already consumed real time."""


class VirtualClock(Clock):
    """Deterministic stream time: advances only via the engine's events
    and explicit ``charge``s of measured work.

    ``quantum`` (optional) rounds every positive ``charge`` UP to a
    multiple of that many seconds.  Chaos/benchmark runs use this to
    absorb scheduler jitter: a measured wall of 0.37 s and one of 0.41 s
    both charge 0.5 s at ``quantum=0.25``, so two seeded runs whose real
    walls differ sub-quantum produce byte-identical timelines.
    """

    def __init__(self, start: float = 0.0, quantum: "float | None" = None):
        self._t = float(start)
        if quantum is not None and quantum <= 0:
            raise ValueError(f"quantum must be positive ({quantum=})")
        self.quantum = quantum

    def now(self) -> float:
        return self._t

    def sleep_until(self, t: float) -> None:
        if t > self._t:
            self._t = float(t)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot rewind the clock ({dt=})")
        self._t += float(dt)

    def charge(self, dt: float) -> None:
        dt = max(0.0, dt)
        if self.quantum is not None and dt > 0:
            # ceil with an epsilon so an exact multiple (e.g. a scripted
            # cost of 2 quanta) doesn't round up to 3 on fp error
            dt = max(1, math.ceil(dt / self.quantum - 1e-9)) * self.quantum
        self.advance(dt)
