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

The port adds a recorder of spans and counters, off until a caller turns
it on (``tracing(True)``):

* ``span(name, **attrs)`` — a context manager that records the block's
  name, thread, ``perf_counter`` start and end, its own id, its parent
  (the enclosing span on the same thread), an optional ``cause`` (the id
  of a span on another thread, ``current()`` there) and its attributes.
  Off, it returns one shared no-op object after a single check (no span
  and no clock read; CPython still makes the call's ``**attrs`` dict).
* ``timed(name, **attrs)`` — a span that always reads its two stamps, for
  the sites whose wall fills a report field (``RequestTiming``,
  ``SwitchReport.t_build``, ``HandoffReport.t_wall``, a standby build's
  wall): the field is the span's ``wall``, so the two never disagree.
* ``count(name, n=1)`` — adds to the innermost open span's attributes on
  the calling thread and to the run's total (``take_counts``).
* ``take_spans()`` / ``take_counts()`` — what every thread recorded since
  the last take, as plain dicts and totals; call them while the threads
  that record are quiet.

Stamps are always the wall ``perf_counter``, never a stream clock: the
recorder says what the host did, on the clock a device trace is put on.
Each thread appends to its own lists (``threading.local``, registered
once), so the hot path takes no lock.  With tracing on and a card
present, ``.item()``, ``.cpu()`` and the other operations that wait on the
card unasked are counted as ``implicit_syncs`` under the open span
(``torch.cuda.set_sync_debug_mode("warn")``, its warnings counted and
never shown).
"""
from __future__ import annotations

import itertools
import re
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional


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


# ---------------------------------------------------------------------------
# the recorder: spans and counters, off until ``tracing(True)``
# ---------------------------------------------------------------------------

_on = False
_local = threading.local()
_logs: List["_ThreadLog"] = []      # every recording thread's log
_ids = itertools.count(1)


class _ThreadLog:
    """One thread's open spans, finished spans and counter totals."""

    __slots__ = ("thread", "stack", "spans", "counts")

    def __init__(self, thread: str):
        self.thread = thread
        self.stack: List[Span] = []
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}


def _log() -> _ThreadLog:
    log = getattr(_local, "log", None)
    if log is None:
        log = _local.log = _ThreadLog(threading.current_thread().name)
        _logs.append(log)           # once a thread; list.append is atomic
    return log


class Span:
    """One block of host work: ``t0``/``t1`` are ``perf_counter`` stamps,
    ``wall`` their difference.  Recorded (``take_spans``) when made with
    tracing on; a ``timed`` span made with it off only times."""

    __slots__ = ("name", "attrs", "cause", "id", "parent", "t0", "t1",
                 "_log")

    def __init__(self, name: str, cause: Optional[int], attrs: dict,
                 log: Optional[_ThreadLog]):
        self.name = name
        self.attrs = attrs
        self.cause = cause
        self.id = next(_ids) if log is not None else None
        self.parent = None
        self.t0 = self.t1 = 0.0
        self._log = log

    def __enter__(self) -> "Span":
        log = self._log
        if log is not None:
            if log.stack:
                self.parent = log.stack[-1].id
            log.stack.append(self)
        self.t0 = time.perf_counter()  # nk: allow[NK02]: the port's own recorder
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()  # nk: allow[NK02]: the port's own recorder
        log = self._log
        if log is not None:
            log.stack.pop()
            log.spans.append(self)
        return False

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _NoSpan:
    """What ``span`` returns with tracing off: enters, exits and records
    nothing."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


def span(name: str, *, cause: Optional[int] = None, **attrs):
    """A recorded span with tracing on, else the shared ``NO_SPAN``."""
    if not _on:
        return NO_SPAN
    return Span(name, cause, attrs, _log())


def timed(name: str, *, cause: Optional[int] = None, **attrs) -> Span:
    """A span that reads its stamps whether or not tracing is on (and is
    recorded only when it is): ``wall`` fills a report field."""
    return Span(name, cause, attrs, _log() if _on else None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` on the innermost open span of this
    thread and to the run's total; nothing with tracing off."""
    if not _on:
        return
    log = _log()
    log.counts[name] = log.counts.get(name, 0) + n
    if log.stack:
        attrs = log.stack[-1].attrs
        attrs[name] = attrs.get(name, 0) + n


def current() -> Optional[int]:
    """The id of this thread's innermost open recorded span (a ``cause``
    for work it hands to another thread), or None."""
    if not _on:
        return None
    stack = _log().stack
    return stack[-1].id if stack else None


def tracing(on: bool) -> None:
    """Turn the recorder on or off.  Spans open when it changes still end
    as they began (recorded or not)."""
    global _on
    on = bool(on)
    if on == _on:
        return
    _on = on
    _implicit_syncs(on)


def take_spans() -> List[dict]:
    """Every finished recorded span since the last take, sorted by start:
    ``name, thread, start, end, id, parent, cause, attrs``."""
    out = []
    for log in list(_logs):
        done, log.spans = log.spans, []
        out.extend({"name": s.name, "thread": log.thread, "start": s.t0,
                    "end": s.t1, "id": s.id, "parent": s.parent,
                    "cause": s.cause, "attrs": dict(s.attrs)} for s in done)
    out.sort(key=lambda r: r["start"])
    return out


def take_counts() -> Dict[str, int]:
    """Every counter's total over all threads since the last take."""
    total: Dict[str, int] = {}
    for log in list(_logs):
        counts, log.counts = log.counts, {}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# -- implicit syncs ----------------------------------------------------------
# PyTorch's sync debug mode warns at every operation that waits on the card
# without being asked to (``.item()``, ``.cpu()``, a copy to pageable
# memory).  With tracing on, each such warning is counted on the open span
# and dropped; an explicit ``wait`` (``device.synchronize``) is counted as
# ``syncs`` there instead.

_SYNC_WARNING = re.compile(r".*called a synchronizing CUDA operation")
_saved_warnings: Optional[warnings.catch_warnings] = None


def _show_sync(message, category, filename, lineno, file=None, line=None):
    if not _SYNC_WARNING.match(str(message)):
        _saved_warnings._showwarning(message, category, filename, lineno,
                                     file, line)
        return
    log = _log()
    if not (log.stack and log.stack[-1].name == "wait"):
        count("implicit_syncs")


def _implicit_syncs(on: bool) -> None:
    """Count implicit syncs (on) or stop and restore the warnings' filters
    and ``showwarning`` as they were (off).  Nothing off the card."""
    global _saved_warnings
    import torch
    if not torch.cuda.is_available():
        return
    if on:
        _saved_warnings = warnings.catch_warnings()
        _saved_warnings.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING.pattern)
        warnings.showwarning = _show_sync
        torch.cuda.set_sync_debug_mode("warn")
    elif _saved_warnings is not None:
        torch.cuda.set_sync_debug_mode("default")
        _saved_warnings.__exit__(None, None, None)
        _saved_warnings = None
