"""Deterministic, seeded fault injection for the switching/serving path.

The port's copy of ``repro/core/faults.py``, logic unchanged.

The reproduction's happy path (every build succeeds, every hand-off
lands, the link degrades but never dies) is exactly what production edge
serving is *not*.  This module is the chaos valve: a ``FaultPlan`` holds
a set of ``FaultInjector``s built from ``+``-joined spec strings —

    faults("build_fail(p=0.3)+link_outage(at=12,dur=5)")

— and the hardened code consults the plan at its injection points:

* ``PipelinePool.ensure`` calls ``plan.on_build(key)`` before building a
  pipeline (may raise ``InjectedBuildFailure`` or stall until
  ``plan.release()``);
* ``StatefulPipelinePool._execute_handoff`` passes the exported state
  payload through ``plan.mutate_handoff`` (corruption/truncation —
  caught downstream by the checksum/epoch envelope);
* ``ServingEngine._execute`` passes each request's measured timing
  through ``plan.perturb_timing`` (slow cloud stages);
* benchmarks transform their ``BandwidthTrace`` through
  ``plan.apply_to_trace`` (outages/flaps).

Every random draw is *keyed* — hashed from ``(seed, injector index,
site key, attempt)`` via ``numpy.random.SeedSequence`` — not drawn from
a shared sequential stream, so outcomes are independent of thread
interleaving and identical seeds give byte-identical
``ServiceTimeline``s on ``VirtualClock``.

Same ``Registry`` idiom as strategies / policies / arrivals: register
injector classes under a name, resolve instances from spec strings.
"""
from __future__ import annotations

import threading
import warnings
import zlib
from dataclasses import replace as _dc_replace
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.concurrency import RANK_FAULT_INJECTOR, guarded_by, make_lock
from repro_torch.core.network import BandwidthTrace
from repro_torch.core.strategies import Registry


class InjectedBuildFailure(RuntimeError):
    """A pipeline build failed (or was abandoned) because a FaultPlan
    said so — distinguishable from organic build errors in tests."""


def _canon_key(key: Any) -> Any:
    """One identity per build no matter how the caller spells the key:
    the pool passes ``PipelineKey``, fault specs and older tests still
    pass legacy ``(split, owns_weights)`` tuples.  Counters and keyed
    draws must agree across both spellings."""
    from repro_torch.core.pool import PipelineKey
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return PipelineKey.of(key)
    except (TypeError, ValueError):    # not a pool key at all: use as-is
        return key


def _keyed_uniform(seed: int, *parts: Any) -> float:
    """Deterministic U[0,1) from ``(seed, *parts)``.

    Hashes the *site key*, not a call counter, so the draw for (say)
    build attempt 3 of split 6 is the same number no matter which thread
    asks first or how many unrelated draws happened in between.
    """
    ints = [int(seed) & 0xFFFFFFFF]
    for p in parts:
        if isinstance(p, (int, np.integer)) and not isinstance(p, bool):
            ints.append(int(p) & 0xFFFFFFFF)
        else:
            ints.append(zlib.crc32(repr(p).encode()))
    ss = np.random.SeedSequence(ints)
    return float(np.random.default_rng(ss).random())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

FAULTS = Registry("fault injector")


def register_fault(name: str, *, override: bool = False):
    """Class decorator adding a FaultInjector to the registry."""
    return FAULTS.register(name, override=override)


def available_faults() -> List[str]:
    return FAULTS.names()


def get_fault(spec, **overrides) -> "FaultInjector":
    """Resolve one injector spec string (or pass an instance through)."""
    return FAULTS.resolve(spec, **overrides)


# ---------------------------------------------------------------------------
# injector base + implementations
# ---------------------------------------------------------------------------

class FaultInjector:
    """One fault family.  Subclasses override only the hooks they
    perturb; every default is a no-op/pass-through.

    Injectors hold no sampling state: each draw goes through
    ``self._u(*site_key)`` which keys on ``(plan.seed, self.index,
    *site_key)``, so results are scheduling-independent.  ``plan`` and
    ``index`` are stamped by ``FaultPlan.__init__``.
    """

    name: ClassVar[str] = "fault"
    plan: Optional["FaultPlan"] = None
    index: int = 0

    def on_build(self, key: Any, attempt: int) -> None:
        """Called just before a pipeline build; may raise or block."""

    def mutate_handoff(self, payload: Dict[Any, Any], *, epoch: int) -> None:
        """Corrupt an exported state payload in place (post-checksum)."""

    def perturb_timing(self, rid: int, timing):
        """Return the (possibly replaced) RequestTiming for request rid."""
        return timing

    def transform_trace(self, trace: BandwidthTrace) -> BandwidthTrace:
        """Overlay link faults on a bandwidth trace (static pre-pass)."""
        return trace

    def _u(self, *parts: Any) -> float:
        assert self.plan is not None, "injector not attached to a FaultPlan"
        return _keyed_uniform(self.plan.seed, self.index, *parts)


def _overlay_windows(trace: BandwidthTrace,
                     windows: Sequence[Tuple[float, float, float]],
                     ) -> BandwidthTrace:
    """Resample ``trace`` with ``(start, end, bw)`` overlay windows.

    Boundary points from both the base trace and the windows become
    steps; within ``[start, end)`` the window bandwidth wins (later
    windows shadow earlier ones).  Adjacent equal-bandwidth steps are
    merged so ``change_points()`` stays minimal.
    """
    points = sorted({t for t, _ in trace.steps}
                    | {w[0] for w in windows} | {w[1] for w in windows})
    steps: List[Tuple[float, float]] = []
    for t in points:
        bw = trace.at(t).bandwidth_mbps
        for start, end, wbw in windows:
            if start <= t < end:
                bw = wbw
        if not steps or steps[-1][1] != bw:
            steps.append((t, bw))
    return BandwidthTrace(steps=steps or list(trace.steps),
                          latency_ms=trace.latency_ms)


@register_fault("build_fail")
class BuildFail(FaultInjector):
    """Fail pipeline builds with ``InjectedBuildFailure``.

    ``times=N`` fails the first N attempts per build key (deterministic
    transient fault — pairs with the executor's retry); otherwise each
    ``(key, attempt)`` draws independently against ``p``.
    """

    def __init__(self, p: float = 1.0, times: Optional[int] = None):
        self.p = float(p)
        self.times = None if times is None else int(times)

    def _hit(self, key: Any, attempt: int) -> bool:
        if self.times is not None:
            return attempt <= self.times
        return self._u("build", key, attempt) < self.p

    def on_build(self, key: Any, attempt: int) -> None:
        if self._hit(key, attempt):
            if self.plan is not None:
                self.plan.note(f"build_fail key={key!r} attempt={attempt}")
            raise InjectedBuildFailure(
                f"injected build failure for {key!r} (attempt {attempt})")


@register_fault("build_stall")
class BuildStall(FaultInjector):
    """Hang pipeline builds until ``plan.release()`` — a wedged compile.

    The switch watchdog (``ServingEngine.switch_timeout_s``) is what
    turns a stalled build into an *aborted* switch instead of a wedged
    serving loop; ``release()`` then lets the zombie thread exit (it
    raises ``InjectedBuildFailure``, since the build it was running has
    been abandoned).
    """

    def __init__(self, p: float = 1.0, times: Optional[int] = None):
        self.p = float(p)
        self.times = None if times is None else int(times)

    def _hit(self, key: Any, attempt: int) -> bool:
        if self.times is not None:
            return attempt <= self.times
        return self._u("stall", key, attempt) < self.p

    def on_build(self, key: Any, attempt: int) -> None:
        if not self._hit(key, attempt):
            return
        if self.plan is not None:
            self.plan.note(f"build_stall key={key!r} attempt={attempt}")
            self.plan.wait_released()
        raise InjectedBuildFailure(
            f"stalled build for {key!r} released after abandonment")


@register_fault("link_outage")
class LinkOutage(FaultInjector):
    """Cloud link drops to 0 Mbps for ``dur`` seconds starting at ``at``."""

    def __init__(self, at: float = 12.0, dur: float = 5.0):
        self.at = float(at)
        self.dur = float(dur)

    def windows(self) -> List[Tuple[float, float, float]]:
        return [(self.at, self.at + self.dur, 0.0)]

    def transform_trace(self, trace: BandwidthTrace) -> BandwidthTrace:
        return _overlay_windows(trace, self.windows())


@register_fault("link_flap")
class LinkFlap(FaultInjector):
    """``n`` short outages starting at ``at``: every ``period`` seconds
    the link goes dark for ``duty * period`` seconds, then recovers."""

    def __init__(self, at: float = 10.0, n: int = 3, period: float = 2.0,
                 duty: float = 0.5):
        self.at = float(at)
        self.n = int(n)
        self.period = float(period)
        self.duty = float(duty)

    def windows(self) -> List[Tuple[float, float, float]]:
        return [(self.at + i * self.period,
                 self.at + i * self.period + self.period * self.duty, 0.0)
                for i in range(self.n)]

    def transform_trace(self, trace: BandwidthTrace) -> BandwidthTrace:
        return _overlay_windows(trace, self.windows())


@register_fault("handoff_corrupt")
class HandoffCorrupt(FaultInjector):
    """Corrupt one tensor of an exported state payload in transit.

    ``mode='flip'`` XORs a keyed byte; ``mode='truncate'`` drops the
    buffer's tail half.  The dunder-named ``"__meta__"`` envelope entry
    is never the victim (the checksum must arrive intact for the
    mismatch to be *detected*).
    """

    def __init__(self, p: float = 1.0, mode: str = "flip"):
        if mode not in ("flip", "truncate"):
            raise ValueError(f"handoff_corrupt mode must be 'flip' or "
                             f"'truncate', got {mode!r}")
        self.p = float(p)
        self.mode = mode

    def mutate_handoff(self, payload: Dict[Any, Any], *, epoch: int) -> None:
        victims = sorted((k for k in payload
                          if not (isinstance(k, str) and k.startswith("__"))),
                         key=repr)
        if not victims or self._u("handoff", epoch) >= self.p:
            return
        k = victims[0]
        dtype, shape, buf = payload[k]
        b = bytearray(buf)
        if not b:
            return
        if self.mode == "truncate":
            payload[k] = (dtype, shape, bytes(b[:max(1, len(b) // 2)]))
        else:
            i = int(self._u("byte", epoch) * len(b)) % len(b)
            b[i] ^= 0xFF
            payload[k] = (dtype, shape, bytes(b))
        if self.plan is not None:
            self.plan.note(f"handoff_corrupt mode={self.mode} epoch={epoch} "
                           f"key={k!r}")


@register_fault("slow_cloud")
class SlowCloud(FaultInjector):
    """Multiply a request's cloud-stage time by ``factor`` with prob ``p``
    (straggling cloud executor / noisy neighbour)."""

    def __init__(self, factor: float = 4.0, p: float = 0.25):
        self.factor = float(factor)
        self.p = float(p)

    def perturb_timing(self, rid: int, timing):
        if self._u("cloud", rid) < self.p:
            return _dc_replace(timing, t_cloud=timing.t_cloud * self.factor)
        return timing


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@guarded_by("_lock", "_build_counts", "_events", rank=RANK_FAULT_INJECTOR)
class FaultPlan:
    """An armed set of injectors sharing one seed.

    Hooks are no-ops until ``arm()``, so a benchmark can construct its
    pools and initial pipelines cleanly and only then open the valve.
    ``on_build`` increments the per-key attempt counter under the plan
    lock but dispatches to injectors *outside* it — injectors may block
    (``build_stall``) and must not wedge other threads' bookkeeping.
    The lock ranks above the pool lock (``RANK_FAULT_INJECTOR``) because
    ``mutate_handoff`` runs inside ``StatefulPipelinePool`` activation.
    """

    def __init__(self, injectors: Sequence[FaultInjector] = (), seed: int = 0):
        self.seed = int(seed)
        self.injectors: Tuple[FaultInjector, ...] = tuple(injectors)
        for i, inj in enumerate(self.injectors):
            inj.plan = self
            inj.index = i
        self.armed = False
        self._released = threading.Event()
        self._lock = make_lock("fault-plan", RANK_FAULT_INJECTOR)
        self._build_counts: Dict[Any, int] = {}
        self._events: List[str] = []

    def __repr__(self):
        names = "+".join(type(i).__name__ for i in self.injectors) or "none"
        return f"FaultPlan({names}, seed={self.seed}, armed={self.armed})"

    # -- lifecycle ------------------------------------------------------
    def arm(self) -> "FaultPlan":
        self.armed = True
        return self

    def disarm(self) -> None:
        self.armed = False

    def release(self) -> None:
        """Unblock every stalled build.  Call before tearing down pools
        so zombie build threads can exit."""
        self._released.set()

    def wait_released(self) -> None:
        self._released.wait()

    # -- event log ------------------------------------------------------
    def note(self, msg: str) -> None:
        with self._lock:
            self._events.append(msg)

    def event_log(self) -> List[str]:
        with self._lock:
            return list(self._events)

    def build_attempts(self, key: Any) -> int:
        key = _canon_key(key)
        with self._lock:
            return self._build_counts.get(key, 0)

    # -- hooks (called by the hardened code) ----------------------------
    def on_build(self, key: Any) -> None:
        if not self.armed:
            return
        key = _canon_key(key)
        with self._lock:
            attempt = self._build_counts.get(key, 0) + 1
            self._build_counts[key] = attempt
        for inj in self.injectors:   # outside the lock: may raise or block
            inj.on_build(key, attempt)

    def mutate_handoff(self, payload: Dict[Any, Any], *, epoch: int) -> None:
        if not self.armed:
            return
        for inj in self.injectors:
            inj.mutate_handoff(payload, epoch=epoch)

    def perturb_timing(self, rid: int, timing):
        if not self.armed:
            return timing
        for inj in self.injectors:
            timing = inj.perturb_timing(rid, timing)
        return timing

    def apply_to_trace(self, trace: BandwidthTrace) -> BandwidthTrace:
        """Static pre-pass: overlay link faults on a scripted trace.
        Applies regardless of ``armed`` — traces are transformed once at
        scenario build time, not sampled during the run."""
        for inj in self.injectors:
            trace = inj.transform_trace(trace)
        return trace


def faults(spec: str, *, seed: int = 0) -> FaultPlan:
    """Build a ``FaultPlan`` from a composite ``+``-joined spec string.

    ``faults("build_fail(p=0.3)+link_outage(at=12,dur=5)")`` — each
    piece resolves through the FAULTS registry with the usual
    ``name(key=literal, ...)`` grammar.  An empty spec gives an inert
    plan (no injectors), handy as the chaos grid's control cell.
    """
    pieces = [p.strip() for p in str(spec).split("+") if p.strip()]
    return FaultPlan([FAULTS.resolve(p) for p in pieces], seed=seed)


FAULTS.base = FaultInjector
