"""Workload generation: arrival processes + multi-client streams.

The port's copy of ``repro/serving/workload.py``, logic unchanged.  It
keeps its own arrival registry (NK04 allowed inline, as the strategies').

The paper measures downtime against one camera emitting frames at a fixed
rate; the ROADMAP's north star is heavy traffic from many concurrent
clients.  This module makes the workload a first-class, swept dimension:

* ``ArrivalProcess`` — a registered generator of arrival times, resolved
  by spec string exactly like the switch strategies
  (``get_arrival("poisson(rate=4)")``).  Every process is **seeded and
  deterministic**: the same ``(spec, seed)`` yields the same arrival
  times, quantised to the nanosecond grid (``clock.quantize``), so runs
  on a ``VirtualClock`` are byte-identical end to end.

  ============  =========================================================
  ``uniform``   the paper's camera: one arrival every ``1/rate`` seconds
  ``poisson``   memoryless arrivals at ``rate`` req/s (exponential gaps)
  ``bursty``    MMPP — a two-state on/off Markov-modulated Poisson
                process: dwell times are exponential with means
                ``mean_on``/``mean_off``; arrivals are Poisson at
                ``rate_on`` inside a burst and ``rate_off`` outside
  ``diurnal``   non-homogeneous Poisson with a sinusoidal day curve,
                sampled by thinning: rate(t) = rate * (1 + amplitude *
                sin(2*pi*(t/period + phase)))
  ============  =========================================================

* ``ClientStream`` — one client of a multi-client engine run: an arrival
  process, the inputs its requests carry, a per-client bounded admission
  queue (``queue_depth``) and an admission ``weight`` (used by the
  engine's weighted-fair dispatcher).  Per-client seeds are derived from
  ``(seed, client index)`` via ``numpy.random.SeedSequence``, so adding a
  client never reshuffles another client's arrivals.

``make_clients`` builds the homogeneous N-client fleets the scenario
matrix sweeps; heterogeneous fleets are just hand-built lists.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.profiler import ModelProfile, UnitProfile
from repro_torch.core.strategies import Registry
from repro_torch.serving.clock import quantize

ARRIVALS = Registry("arrival process")


def register_arrival(name: str, *, override: bool = False):
    """Class decorator adding an ArrivalProcess to the registry."""
    return ARRIVALS.register(name, override=override)


def available_arrivals() -> List[str]:
    return ARRIVALS.names()


def get_arrival(spec: Union[str, "ArrivalProcess"],
                **overrides) -> "ArrivalProcess":
    """Resolve ``"bursty(rate_on=40)"``-style specs (or pass through)."""
    return ARRIVALS.resolve(spec, **overrides)


class ArrivalProcess:
    """A seeded, deterministic generator of request arrival times."""

    name = "?"

    @property
    def spec(self) -> str:
        return self.name

    def times(self, duration: float, *, seed: int = 0,
              start: float = 0.0) -> Iterator[float]:
        """Arrival times in ``[start, start + duration)``, ascending,
        quantised to the nanosecond grid.  Identical ``seed`` -> identical
        stream."""
        raise NotImplementedError

    def mean_rate(self) -> float:
        """Long-run arrivals/second (used for sanity checks and sizing)."""
        raise NotImplementedError


ARRIVALS.base = ArrivalProcess


@register_arrival("uniform")  # nk: allow[NK04]: the port's own registry
class UniformArrivals(ArrivalProcess):
    """The paper's camera: a fixed-rate frame grid (seed is ignored)."""

    def __init__(self, rate: float = 2.0):
        if rate <= 0:
            raise ValueError(f"rate must be positive ({rate=})")
        self.rate = float(rate)

    @property
    def spec(self) -> str:
        return f"uniform(rate={self.rate})"

    def times(self, duration, *, seed=0, start=0.0):
        # index multiplication, not gap accumulation: no float drift
        i = 0
        while True:
            t = quantize(start + i / self.rate)
            if t >= start + duration - 1e-12:
                return
            yield t
            i += 1

    def mean_rate(self) -> float:
        return self.rate


@register_arrival("poisson")  # nk: allow[NK04]: the port's own registry
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals: exponential inter-arrival gaps at ``rate``."""

    def __init__(self, rate: float = 2.0):
        if rate <= 0:
            raise ValueError(f"rate must be positive ({rate=})")
        self.rate = float(rate)

    @property
    def spec(self) -> str:
        return f"poisson(rate={self.rate})"

    def times(self, duration, *, seed=0, start=0.0):
        rng = np.random.default_rng(seed)
        t = start
        end = start + duration
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t >= end:
                return
            yield quantize(t)

    def mean_rate(self) -> float:
        return self.rate


@register_arrival("bursty")  # nk: allow[NK04]: the port's own registry
class BurstyArrivals(ArrivalProcess):
    """Two-state MMPP: Poisson at ``rate_on`` inside exponential-dwell
    bursts, ``rate_off`` between them.

    Because Poisson arrivals are memoryless, jumping to the state
    boundary when a drawn gap overshoots it (and re-drawing in the new
    state) samples the exact process.  Starts in the *off* state so the
    stream has a measurable quiet baseline before the first burst.
    """

    def __init__(self, rate_on: float = 20.0, rate_off: float = 0.5,
                 mean_on: float = 2.0, mean_off: float = 4.0):
        if rate_on <= 0 or rate_off < 0:
            raise ValueError(f"bad rates ({rate_on=}, {rate_off=})")
        if mean_on <= 0 or mean_off <= 0:
            raise ValueError(f"bad dwell means ({mean_on=}, {mean_off=})")
        self.rate_on = float(rate_on)
        self.rate_off = float(rate_off)
        self.mean_on = float(mean_on)
        self.mean_off = float(mean_off)

    @property
    def spec(self) -> str:
        return (f"bursty(rate_on={self.rate_on}, rate_off={self.rate_off}, "
                f"mean_on={self.mean_on}, mean_off={self.mean_off})")

    def times(self, duration, *, seed=0, start=0.0):
        rng = np.random.default_rng(seed)
        t = start
        end = start + duration
        on = False
        state_end = start + rng.exponential(self.mean_off)
        while t < end:
            rate = self.rate_on if on else self.rate_off
            if rate <= 0.0:            # silent state: skip to its end
                t = state_end
            else:
                nxt = t + rng.exponential(1.0 / rate)
                if nxt < state_end:
                    t = nxt
                    if t >= end:
                        return
                    yield quantize(t)
                    continue
                t = state_end
            on = not on
            state_end = t + rng.exponential(self.mean_on if on
                                            else self.mean_off)

    def mean_rate(self) -> float:
        w_on = self.mean_on / (self.mean_on + self.mean_off)
        return w_on * self.rate_on + (1.0 - w_on) * self.rate_off


@register_arrival("diurnal")  # nk: allow[NK04]: the port's own registry
class DiurnalArrivals(ArrivalProcess):
    """Non-homogeneous Poisson with a sinusoidal intensity (a compressed
    day), sampled exactly by thinning against the peak rate."""

    def __init__(self, rate: float = 4.0, amplitude: float = 0.8,
                 period: float = 60.0, phase: float = 0.0):
        if rate <= 0 or not (0.0 <= amplitude <= 1.0) or period <= 0:
            raise ValueError(f"bad diurnal params ({rate=}, {amplitude=}, "
                             f"{period=})")
        self.rate = float(rate)
        self.amplitude = float(amplitude)
        self.period = float(period)
        self.phase = float(phase)

    @property
    def spec(self) -> str:
        return (f"diurnal(rate={self.rate}, amplitude={self.amplitude}, "
                f"period={self.period})")

    def rate_at(self, t: float) -> float:
        return self.rate * (1.0 + self.amplitude * np.sin(
            2.0 * np.pi * (t / self.period + self.phase)))

    def times(self, duration, *, seed=0, start=0.0):
        rng = np.random.default_rng(seed)
        rate_max = self.rate * (1.0 + self.amplitude)
        t = start
        end = start + duration
        while True:
            t += rng.exponential(1.0 / rate_max)
            if t >= end:
                return
            if rng.uniform() * rate_max < self.rate_at(t):
                yield quantize(t)

    def mean_rate(self) -> float:
        return self.rate


# ---------------------------------------------------------------------------
# multi-client streams
# ---------------------------------------------------------------------------

@dataclass
class ClientStream:
    """One client of a multi-client engine run.

    ``queue_depth`` bounds this client's admission queue: 0 is the
    paper's camera (an arrival that cannot start immediately is dropped),
    k > 0 lets up to k requests wait for the edge stage.  ``weight``
    feeds the engine's weighted-fair dispatcher (ignored under plain
    round-robin).
    """

    client_id: str
    arrival: Union[str, ArrivalProcess]
    inputs: Any = None
    weight: float = 1.0
    queue_depth: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be positive ({self.weight=})")
        if self.queue_depth < 0:
            raise ValueError(f"queue_depth must be >= 0 "
                             f"({self.queue_depth=})")

    @property
    def process(self) -> ArrivalProcess:
        return get_arrival(self.arrival)

    def arrivals(self, duration: float, start: float = 0.0
                 ) -> Iterator[Tuple[float, Any]]:
        """(t_arrival, inputs) pairs for this client's seeded stream."""
        for t in self.process.times(duration, seed=self.seed, start=start):
            yield t, self.inputs


def client_seed(base_seed: int, index: int) -> int:
    """Stable per-client seed: adding client N never reshuffles 0..N-1."""
    ss = np.random.SeedSequence(base_seed, spawn_key=(index,))
    return int(ss.generate_state(1, np.uint64)[0])


def pinned_split_profile(num_layers: int, *, t_edge: float = 0.030,
                         t_cloud: float = 0.003) -> ModelProfile:
    """Eq.-1 landscape whose optimum is pinned at ``split == num_layers``
    for EVERY bandwidth (the boundary after the last layer is ~free, all
    earlier ones huge).  The SLO tests and the scenario-matrix SLO cell
    share it: with the network path never wanting to move, the only
    repartition pressure left is the measured p99."""
    units = [UnitProfile("embed", 0.0, 0.0, 50_000_000)]
    units += [UnitProfile(f"l{i}", t_edge, t_cloud,
                          10_000_000 if i < num_layers - 1 else 10_000)
              for i in range(num_layers)]
    units += [UnitProfile("head", t_edge, t_cloud, 0)]
    return ModelProfile("slo-pinned", units)


def slo_threshold(timing, slack_units: float = 6.0) -> float:
    """An SLO sitting well above steady-state service (``timing`` from a
    warm request) but far below the queueing delay a burst builds through
    the bounded per-client queues — the violation band the ``slo_aware``
    policy is meant to react inside."""
    return timing.total + slack_units * timing.t_edge


def make_clients(n: int, arrival: Union[str, ArrivalProcess], inputs, *,
                 queue_depth: int = 0, seed: int = 0,
                 weights: Optional[Sequence[float]] = None
                 ) -> List[ClientStream]:
    """A homogeneous fleet of ``n`` clients sharing one arrival spec but
    each drawing from its own derived seed."""
    weights = list(weights) if weights is not None else [1.0] * n
    if len(weights) != n:
        raise ValueError(f"{n} clients but {len(weights)} weights")
    return [ClientStream(client_id=f"c{i}", arrival=arrival, inputs=inputs,
                         weight=weights[i], queue_depth=queue_depth,
                         seed=client_seed(seed, i))
            for i in range(n)]
