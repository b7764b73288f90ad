"""Concurrency contracts: lock-discipline annotations + a checking lock.

Two complementary enforcement layers share one vocabulary:

* ``@guarded_by("_lock", "attr", ...)`` declares which instance
  attributes a class's lock protects.  ``repro.analysis`` rule **NK01**
  reads the declaration *statically* and flags any read/write of a
  guarded attribute outside a ``with self._lock`` block.  At runtime the
  decorator only records metadata (``__nk_guarded__``) — it costs
  nothing on the hot path.
* ``make_lock(name, rank)`` builds the lock itself.  Normally a plain
  ``threading.RLock``; with ``NEUKONFIG_DEBUG_LOCKS=1`` (the default
  under pytest) it returns a ``DebugLock`` that asserts the same
  acquisition-order contract NK01 checks statically: locks must be taken
  in increasing ``rank`` order, and a thread acquiring out of order
  raises ``LockOrderError`` at the exact inversion site — the dynamic
  complement to the static rule.

Canonical ranks (outermost first).  The serving thread takes the pool
lock and, still holding it, submits to the build executor; the executor
never takes the pool lock while holding its own — so pool < executor.
Handle callbacks are registered under the pool lock; stage-cache and
session locks are innermost leaf locks around pure dict/state access.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Optional, Tuple

RANK_BREAKER = 8        # CircuitBreaker._lock (never held across other locks)
RANK_POOL = 10          # PipelinePool._lock / StatefulPipelinePool._lock
RANK_EXECUTOR = 20      # BuildExecutor._lock (+ its _idle condition)
RANK_HANDLE = 30        # BuildHandle._cb_lock
RANK_STAGE_CACHE = 40   # _CompiledStageCache._cache_lock
RANK_STATEFUL_RUNNER = 42   # StatefulStageRunner._lock
RANK_FAULT_INJECTOR = 45    # FaultPlan._lock (taken under the pool lock
                            # by the hand-off mutation hook; leaf-like:
                            # nothing is acquired while it is held)
RANK_SESSION_MANAGER = 47   # SessionManager._lock (slot-pool metadata;
                            # never held across runner/compile calls, so
                            # it sits between the runner lock it must not
                            # nest under and the per-session leaf lock)
RANK_SESSION = 50       # DecodeSession._lock (innermost)


def guarded_by(lock: str, *attrs: str, rank: Optional[int] = None,
               aliases: Tuple[str, ...] = (),
               init_methods: Tuple[str, ...] = ()):
    """Class decorator: ``attrs`` may only be touched under ``self.<lock>``.

    ``aliases`` are other attribute names holding the *same* lock (e.g. a
    ``threading.Condition`` wrapping it), so ``with self._idle:`` counts
    as holding ``_lock``.  ``init_methods`` are constructor helpers that
    run before the object is shared and are exempt (``__init__`` always
    is).  ``rank`` feeds the acquisition-order check (NK01 static /
    ``DebugLock`` dynamic); omit it for classes outside the order graph.
    """
    def deco(cls):
        spec = {"lock": lock, "attrs": tuple(attrs), "rank": rank,
                "aliases": tuple(aliases), "init_methods": tuple(init_methods)}
        existing = list(getattr(cls, "__nk_guarded__", ()))
        # stack multiple @guarded_by decorators for multi-lock classes;
        # don't mutate a base class's list through inheritance
        if "__nk_guarded__" not in cls.__dict__:
            existing = list(existing)
        existing.append(spec)
        cls.__nk_guarded__ = tuple(existing)
        return cls
    return deco


def debug_locks_enabled() -> bool:
    """NEUKONFIG_DEBUG_LOCKS=1 forces on, =0 forces off; otherwise on
    exactly when running under pytest (checked per make_lock call, so a
    test-constructed pool is always order-checked)."""
    env = os.environ.get("NEUKONFIG_DEBUG_LOCKS")
    if env is not None and env != "":
        return env != "0"
    return "pytest" in sys.modules


class LockOrderError(RuntimeError):
    """A thread acquired locks against the declared rank order."""


_held = threading.local()       # per-thread: list of DebugLocks, outer first


def _held_stack():
    try:
        return _held.stack
    except AttributeError:
        _held.stack = []
        return _held.stack


class DebugLock:
    """RLock wrapper asserting rank-ordered acquisition.

    Reentrant acquisition of a lock already held is always legal (it adds
    no ordering edge).  Acquiring a lock whose rank is <= the rank of a
    *different* lock this thread already holds inverts the declared order
    and raises ``LockOrderError`` immediately — turning a latent deadlock
    into a deterministic test failure at the inversion site.

    Implements the ``_release_save``/``_acquire_restore``/``_is_owned``
    protocol so ``threading.Condition(DebugLock(...))`` works; a
    post-``wait()`` reacquire restores held-state without re-running the
    order check (the wait already published the ordering edge at first
    acquire).
    """

    def __init__(self, name: str, rank: int):
        self.name = name
        self.rank = rank
        self._inner = threading.RLock()

    def __repr__(self):
        return f"DebugLock({self.name!r}, rank={self.rank})"

    def _check_order(self) -> None:
        for held in _held_stack():
            if held is self:
                return              # reentrant: no new edge
        for held in _held_stack():
            if held.rank >= self.rank:
                raise LockOrderError(
                    f"lock order inversion: acquiring {self.name!r} "
                    f"(rank {self.rank}) while holding {held.name!r} "
                    f"(rank {held.rank}); declared order is strictly "
                    f"increasing rank")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self) -> None:
        stack = _held_stack()
        # pop the innermost occurrence (reentrant releases unwind LIFO)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- threading.Condition protocol ----------------------------------
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        stack = _held_stack()
        n = stack.count(self)
        for _ in range(n):
            stack.remove(self)
        return n, self._inner._release_save()

    def _acquire_restore(self, state):
        n, inner_state = state
        self._inner._acquire_restore(inner_state)
        _held_stack().extend([self] * n)


def make_lock(name: str, rank: int):
    """The lock factory every ranked lock in the codebase goes through."""
    if debug_locks_enabled():
        return DebugLock(name, rank)
    return threading.RLock()
