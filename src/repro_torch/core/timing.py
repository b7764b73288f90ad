"""Sanctioned wall-clock measurement primitives.

Every wall measurement in the serving/switching path routes through this
module (or through ``repro.serving.clock``); raw ``time.perf_counter()``
anywhere else in ``src/`` is an NK02 finding (``repro.analysis``).  The
point is auditability: downtime numbers are only trustworthy if every
timer either feeds the stream ``Clock`` (deterministic under
``VirtualClock``) or is a deliberate, greppable wall site.

* ``Stopwatch`` — span timing across non-contiguous code (start here,
  read elapsed there): the ``t_begin``/``t_blocked`` pattern in the
  switch strategies.
* ``measure()`` — context-managed block timing; pass ``charge_to=clock``
  to replay the measured wall onto a stream clock on exit
  (``Clock.measure()`` is the bound convenience form).
* ``now()`` — a monotonic wall timestamp for deadlines on *real* thread
  waits (build drains, handle timeouts), which stay wall-time by nature
  even under a virtual stream clock.

This is the port's copy of ``repro/core/timing.py``.  NK02 exempts only
the reference module's path, so each raw wall site here carries an
inline allow.  On a CUDA device the caller synchronises before reading a
span: kernel launches return before the card finishes.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator, Optional


def now() -> float:
    """Monotonic wall timestamp (seconds): deadlines on real thread waits."""
    return time.perf_counter()  # nk: allow[NK02]: the port's own Stopwatch


class Stopwatch:
    """Wall-clock span timer: created running, read via ``elapsed()``."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter()  # nk: allow[NK02]: the port's own Stopwatch

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0  # nk: allow[NK02]: the port's own Stopwatch

    def restart(self) -> float:
        """Read the current span and start a new one."""
        t = time.perf_counter()  # nk: allow[NK02]: the port's own Stopwatch
        dt = t - self._t0
        self._t0 = t
        return dt


class Measurement:
    """Result box for ``measure()``: ``wall`` is valid after the block."""

    __slots__ = ("wall",)

    def __init__(self):
        self.wall = 0.0


@contextmanager
def measure(charge_to=None) -> Iterator[Measurement]:
    """Time a block; optionally charge the measured wall to a stream clock.

    ``charge_to`` is any object with ``charge(dt)`` — a
    ``repro.serving.clock.Clock``.  The charge happens even if the block
    raises: a failed switch still blocked the stream for as long as it
    ran.
    """
    m = Measurement()
    sw = Stopwatch()
    try:
        yield m
    finally:
        m.wall = sw.elapsed()
        if charge_to is not None:
            charge_to.charge(m.wall)
