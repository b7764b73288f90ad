"""BuildExecutor: the worker thread behind overlapped switching.

NEUKONFIG's central claim is that a new pipeline is initialised *while the
old one keeps serving*.  This module supplies the mechanism: a single
daemon worker thread that runs pipeline builds off the serving thread.
XLA compilation releases the GIL, so a background trace+compile genuinely
overlaps foreground `process()` calls on CPython.

Design points:

* ``submit`` returns a ``BuildHandle`` immediately; the serving thread
  never blocks on a build unless it explicitly ``wait``s.
* A failed build never kills the worker: the exception is captured on the
  handle and surfaced by ``drain()``/``wait()`` on the *calling* thread as
  a ``BackgroundBuildFailed`` warning — deterministic, testable, and the
  service keeps running on the old pipeline (the paper's availability
  story must survive a broken rebuild).  A failed *completion callback*
  is a different animal — the build succeeded — and warns under the
  distinct ``BuildCallbackFailed`` category.
* Transient build failures (OOM races, flaky remote weight stores,
  injected chaos) are retried on the worker when a ``RetryPolicy`` is
  attached: capped exponential backoff with seeded jitter and an
  optional overall deadline, attempt count surfaced on the handle.
* ``drain()`` blocks until every submitted job has finished, which is how
  tier-1 tests stay single-threaded-reproducible: do async work, drain,
  then assert.
* ``inline=True`` turns the executor into a synchronous stub (jobs run on
  the calling thread at submit time) for environments where threads are
  unavailable or determinism must be absolute.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from repro_torch.core import timing
from repro_torch.core.concurrency import (RANK_EXECUTOR, RANK_HANDLE, guarded_by,
                                    make_lock)


class BackgroundBuildFailed(UserWarning):
    """A background pipeline build raised; service continuity is unaffected."""


class BuildCallbackFailed(UserWarning):
    """A completion *callback* raised.  The build itself succeeded — do
    not confuse this with ``BackgroundBuildFailed`` (chaos tests key off
    the distinction)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff for transient build failures.

    ``delay(attempt)`` is the sleep after failed attempt ``attempt``
    (1-based): ``base_s * factor**(attempt-1)``, scaled by a seeded
    jitter factor in ``[1, 1 + jitter)``, capped at ``cap_s``.  The
    jitter draw is keyed on ``(seed, attempt)`` — pure function, no
    shared RNG stream — so identical seeds give byte-identical
    schedules regardless of thread interleaving.  ``factor >= 1 +
    jitter`` is enforced so the pre-cap schedule is monotone
    nondecreasing (worst case: max jitter this attempt, zero next).

    ``deadline_s`` bounds the whole retry span relative to submission:
    a retry whose backoff would land past ``t_submit + deadline_s`` is
    abandoned and the last error surfaces.
    """
    max_attempts: int = 3
    base_s: float = 0.05
    factor: float = 2.0
    cap_s: float = 1.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s < 0 or self.cap_s < 0 or self.jitter < 0:
            raise ValueError("base_s, cap_s and jitter must be >= 0")
        if self.factor < 1.0 + self.jitter:
            raise ValueError("factor must be >= 1 + jitter for a monotone "
                             "backoff schedule")

    def delay(self, attempt: int) -> float:
        u = (zlib.crc32(f"{self.seed}:{attempt}".encode()) % 10**6) / 10**6
        raw = self.base_s * self.factor ** (attempt - 1) * (1.0 + self.jitter * u)
        return min(self.cap_s, raw)

    def schedule(self, n: Optional[int] = None) -> List[float]:
        """The first ``n`` backoff delays (default: all this policy allows)."""
        n = self.max_attempts - 1 if n is None else n
        return [self.delay(a) for a in range(1, n + 1)]


@guarded_by("_cb_lock", "_callbacks", "_completed", rank=RANK_HANDLE)
class BuildHandle:
    """Future-like handle for one submitted build job."""

    def __init__(self, fn: Callable[[], Any], key: Any = None,
                 retry: Optional[RetryPolicy] = None, span: str = "build"):
        self.fn = fn
        self.key = key
        self.retry = retry
        self.span = span            # the job's recorded span (timing.timed)
        self.cause = timing.current()   # the submitter's open span, if any
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.attempts = 0           # build attempts actually executed
        self.t_submit = timing.now()
        self.t_wall = 0.0           # execution wall time (on the worker)
        self._event = threading.Event()
        self._completed = False     # job body finished (callbacks may still run)
        self._callbacks: List[Callable[["BuildHandle"], None]] = []
        self._cb_lock = make_lock("build-handle", RANK_HANDLE)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def failed(self) -> bool:
        return self.error is not None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job finished; True if it did within ``timeout``."""
        return self._event.wait(timeout)

    def add_done_callback(self, fn: Callable[["BuildHandle"], None]) -> None:
        """Run ``fn(handle)`` after completion (immediately if already done).

        Callbacks run on the worker thread (or the submitting thread for an
        inline executor / already-done handle); they must not block.
        """
        run_now = False
        with self._cb_lock:
            if self._completed:
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            fn(self)

    # -- worker side -----------------------------------------------------
    def _run(self) -> None:
        with timing.timed(self.span, cause=self.cause) as sp:
            self._attempt()
        self.t_wall = sp.wall
        with self._cb_lock:
            self._completed = True
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception as e:
                warnings.warn(f"build completion callback raised: {e!r}",
                              BuildCallbackFailed)
        # the event fires only after every registered callback ran, so
        # wait()/drain() observing completion also observe the callbacks'
        # effects (failure records, report fields, registry cleanup)
        self._event.set()

    def _attempt(self) -> None:
        """Run the job, retried under the handle's policy."""
        policy = self.retry
        max_attempts = policy.max_attempts if policy is not None else 1
        deadline = None
        if policy is not None and policy.deadline_s is not None:
            deadline = self.t_submit + policy.deadline_s
        while True:
            self.attempts += 1
            try:
                self.result = self.fn()
                self.error = None           # a retry redeemed earlier failures
                break
            except BaseException as e:      # surfaced later, never fatal
                self.error = e
            if self.attempts >= max_attempts:
                break
            backoff = policy.delay(self.attempts)
            if deadline is not None and timing.now() + backoff > deadline:
                break                       # would retry past the deadline
            time.sleep(backoff)


@guarded_by("_lock", "_outstanding", "_shutdown", "_thread",
            rank=RANK_EXECUTOR, aliases=("_idle",))
class BuildExecutor:
    """Single background worker that runs build jobs FIFO.

    One worker (not a pool) is deliberate: concurrent *jobs* would contend
    for the same XLA compilation threads and interleave pool mutations;
    within one job, `EdgeCloudPipeline.build` already compiles its two
    stages in parallel.
    """

    def __init__(self, name: str = "neukonfig-build", inline: bool = False,
                 retry: Optional[RetryPolicy] = None):
        self.name = name
        self.inline = inline
        self.retry = retry          # default policy stamped on every handle
        self._q: "queue.SimpleQueue[Optional[BuildHandle]]" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._lock = make_lock("executor", RANK_EXECUTOR)
        self._outstanding = 0
        self._idle = threading.Condition(self._lock)
        self._shutdown = False

    # -- submission -------------------------------------------------------
    def submit(self, fn: Callable[[], Any], *, key: Any = None,
               retry: Optional[RetryPolicy] = None,
               span: str = "build") -> BuildHandle:
        """Queue ``fn``; its run is recorded as a ``span`` whose ``cause``
        is the submitter's open span."""
        handle = BuildHandle(fn, key=key,
                             retry=self.retry if retry is None else retry,
                             span=span)
        if self.inline:
            handle._run()
            return handle
        with self._lock:
            if self._shutdown:
                raise RuntimeError("BuildExecutor is shut down")
            self._outstanding += 1
            self._ensure_worker()
        self._q.put(handle)
        return handle

    def _ensure_worker(self) -> None:   # holds: _lock
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, name=self.name,
                                            daemon=True)
            self._thread.start()

    # -- worker loop ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            handle = self._q.get()
            if handle is None:                  # shutdown sentinel
                return
            handle._run()
            with self._idle:
                self._outstanding -= 1
                if self._outstanding == 0:
                    self._idle.notify_all()

    # -- synchronisation ---------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job completed; True on success."""
        if self.inline:
            return True
        with self._idle:
            # nk: allow[NK01]: wait_for runs the predicate with the lock held
            return self._idle.wait_for(lambda: self._outstanding == 0,
                                       timeout=timeout)

    def shutdown(self, *, drain: bool = True) -> None:
        if drain:
            self.drain()
        with self._lock:
            self._shutdown = True
            thread = self._thread
        if thread is not None and thread.is_alive():
            self._q.put(None)
            thread.join(timeout=5.0)
