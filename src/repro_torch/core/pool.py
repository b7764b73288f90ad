"""PipelinePool: the shared substrate all switching strategies operate on.

The port's copy of ``repro/core/pool.py``.  A key's ``mesh_shape`` puts
its pipeline's cloud stage on a tensor-parallel mesh
(``repro_torch.distributed.tp``), and an activation that changes the mesh
shape reshards on the stream (``ReshardReport``).  A ``fault_plan``
(``core/faults.py``) is consulted before every build, as in the
reference.  The base pool builds stateless ``EdgeCloudPipeline``s;
``StatefulPipelinePool`` overrides ``_new_pipeline`` with its decode
pipelines.

The pool owns every built ``EdgeCloudPipeline``, keyed by a frozen
``PipelineKey`` (``split``, ``mesh_shape``, ``owns_weights``, with room
for a model ``variant`` per ROADMAP item 3):

* ``owns_weights=False`` entries share the runner's weight buffers (the
  paper's "same container" / Case-2 configurations, 1x memory) and reuse
  the runner's compiled-stage caches for warm builds;
* ``owns_weights=True`` entries hold a second weight copy (Case-1 standby
  / "new container", +1x memory each) and are charged against the pool's
  ``mem_budget_bytes``.

Exactly one entry is *active* (serving); any number of others are kept
warm.  When the charged bytes of non-active entries exceed the budget the
pool evicts least-recently-used entries (the active pipeline is never
evicted; a designated Scenario-A standby is evicted last).  Strategies
never construct pipelines directly — they call ``ensure`` / ``activate``
/ ``release`` so that memory accounting (paper Table I) stays in one
place.

Async lifecycle (overlapped switching).  Builds can also run off the
serving thread: ``submit_build`` hands the job to a ``BuildExecutor``
worker and returns a ``BuildHandle`` immediately, registering the key in
a *pending-build* registry.  While a key is pending:

* duplicate ``submit_build`` calls coalesce onto the same handle,
* ``release``/eviction refuse to reap it (an in-flight build must not be
  torn down under the worker),
* ``wait(split, owns_weights)`` blocks until it lands, and
* ``drain()`` blocks until *all* pending builds land — the deterministic
  barrier tier-1 tests and benchmarks use before asserting pool state.

A failed background build never kills the worker or the service: the
error is recorded and surfaced as a ``BackgroundBuildFailed`` warning on
the next ``wait``/``drain`` (on the calling thread, deterministically).
The pool's mutating operations are guarded by an RLock, so the serving
thread's pointer swap never races the worker's entry insertion.

Stateful pools additionally carry a ``session`` — a single
``DecodeSession`` or a slot-indexed ``SessionManager`` — whose per-layer
decode state rides every activation via export/import (or masked
recompute); see ``repro.core.stateful`` and ``repro.serving.sessions``.
``memory_report()`` charges only pipeline weights; session slot-pool
state is budgeted separately by the manager's own ``mem_budget_bytes``.
"""
from __future__ import annotations

import os
import tempfile
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.core import timing
from repro_torch.core.concurrency import RANK_POOL, guarded_by, make_lock
from repro_torch.core.executor import (BackgroundBuildFailed, BuildExecutor,
                                 BuildHandle)
from repro_torch.core.network import NetworkModel
from repro_torch.core.pipeline import BuildReport, EdgeCloudPipeline

# sentinel: "caller did not say" — distinct from an explicit mesh_shape=None
# (an explicitly unsharded cloud stage)
_UNSET = object()


@dataclass(frozen=True)
class PipelineKey:
    """First-class pool key: which pipeline *configuration* an entry holds.

    ``split`` is the edge/cloud partition point; ``mesh_shape`` is the
    cloud-stage device mesh (None = single-device cloud executable);
    ``owns_weights`` distinguishes the paper's Case-1 second-weight-copy
    standbys from shared-weight entries; ``variant`` is reserved for
    model-variant switching (quantized/distilled edge stages, ROADMAP
    item 3) so adding it later is not another key migration.

    Replaces the ad-hoc ``(split, owns_weights)`` tuples that used to be
    threaded through the pool, the strategies and the ``BuildExecutor``.
    Legacy tuples are still accepted everywhere a key is taken, via
    :meth:`of`, with a ``DeprecationWarning`` — for one release.
    """
    split: int
    owns_weights: bool = False
    mesh_shape: Optional[Tuple[int, ...]] = None
    variant: str = ""

    def __post_init__(self):
        if self.mesh_shape is not None:
            object.__setattr__(self, "mesh_shape",
                               tuple(int(d) for d in self.mesh_shape))

    @classmethod
    def of(cls, key) -> "PipelineKey":
        """Normalize a key: PipelineKey passes through, a legacy
        ``(split, owns_weights)`` tuple is shimmed with a warning."""
        if isinstance(key, cls):
            return key
        if isinstance(key, tuple) and len(key) == 2 \
                and not isinstance(key[0], tuple):
            warnings.warn(
                "(split, owns_weights) tuple pool keys are deprecated; "
                "construct a repro.core.pool.PipelineKey instead",
                DeprecationWarning, stacklevel=3)
            return cls(split=int(key[0]), owns_weights=bool(key[1]))
        raise TypeError(f"not a pool key: {key!r}")


# Deprecated alias: the pre-PipelineKey name.  Kept so existing
# ``from repro_torch.core.pool import PoolKey`` imports keep type-checking.
PoolKey = PipelineKey


class SwitchAborted(RuntimeError):
    """Raised inside a fenced switch thread: the watchdog abandoned this
    switch, so its pool mutations (activate/pause) must not land."""


class SwitchAbortedWarning(UserWarning):
    """A switch was timed out by the watchdog and rolled back."""


@dataclass
class ReshardReport:
    """One mesh-shape transition executed at activation time.

    ``t_wall`` is measured ON THE STREAM (inside ``activate``, under the
    same lock the pointer swap takes): it is downtime, and the switch
    owner folds it into ``SwitchReport.t_reshard``.  ``moved_bytes`` is
    the logical size of the buffers that actually changed placement (0
    weight bytes for a prebuilt standby, whose weights were placed at
    build time)."""
    old_mesh: Optional[Tuple[int, ...]]
    new_mesh: Optional[Tuple[int, ...]]
    t_wall: float = 0.0
    moved_bytes: int = 0


@dataclass
class PoolEntry:
    key: PipelineKey
    pipeline: Any
    report: Optional[BuildReport]
    last_used: int = 0
    # session-state version this entry was last synced to (stateful pools:
    # a standby built against an older context is re-synced at swap, never
    # trusted).  -1 = built before any state existed / stateless pool.
    state_epoch: int = -1

    @property
    def split(self) -> int:
        return self.key.split

    @property
    def owns_weights(self) -> bool:
        return self.key.owns_weights

    @property
    def mesh_shape(self) -> Optional[Tuple[int, ...]]:
        return self.key.mesh_shape

    @property
    def charged_bytes(self) -> int:
        """Bytes this entry adds beyond the shared runner weights."""
        return self.pipeline.live_param_bytes() if self.owns_weights else 0


@guarded_by("_lock", "_entries", "_pending", "_build_failures",
            "_standby_handle", "_executor", "_clock",
            "_aborted_switch_threads", "_pause_epoch",
            "active_key", "standby_key", "_paused_key", "mesh_shape",
            "last_reshard", "reshards", rank=RANK_POOL)
class PipelinePool:
    """Owns N built pipelines plus the checkpoint Pause-and-Resume reloads."""

    def __init__(self, runner, net: NetworkModel, sample_inputs,
                 *, checkpoint_path: Optional[str] = None,
                 mem_budget_bytes: Optional[int] = None,
                 standby_owns_weights: bool = True,
                 warm_standbys: bool = False,
                 max_entries: int = 16,
                 executor: Optional[BuildExecutor] = None,
                 fault_plan=None,
                 mesh_shape: Optional[Tuple[int, ...]] = None):
        self.runner = runner
        # chaos valve (repro_torch.core.faults.FaultPlan or None): consulted
        # before every pipeline build; unguarded — armed/swap is a
        # benign publish, injectors do their own locking
        self.fault_plan = fault_plan
        self.net = net
        self.sample_inputs = sample_inputs
        self.mem_budget_bytes = mem_budget_bytes
        self.standby_owns_weights = standby_owns_weights
        # the paper's Scenario-A standby is an *always-running* container:
        # warm_standbys=True runs one throwaway forward after each standby
        # build so the first live request after a swap sees steady-state
        # latency (the serving engine's measured streams enable this;
        # default off to keep unit-test pools cheap)
        self.warm_standbys = warm_standbys
        self.max_entries = max_entries
        # the cloud-mesh shape NEW builds target (None = single-device).
        # A mesh-shape-changing repartition is: set_mesh_shape(new), then
        # run any registered strategy: its builds key on the new shape
        # and activation reshards weights + decode state on the stream.
        self.mesh_shape = (tuple(int(d) for d in mesh_shape)
                           if mesh_shape is not None else None)
        self._entries: Dict[PipelineKey, PoolEntry] = {}
        self._clock = 0
        self.active_key: Optional[PipelineKey] = None
        self.standby_key: Optional[PipelineKey] = None
        self._paused_key: Optional[PipelineKey] = None
        self._checkpoint_path = checkpoint_path
        self._lock = make_lock("pool", RANK_POOL)
        self._executor = executor
        self._pending: Dict[PipelineKey, BuildHandle] = {}
        self._standby_handle: Optional[BuildHandle] = None
        self._build_failures: List[Tuple[PipelineKey, BaseException]] = []
        self._aborted_switch_threads: Set[threading.Thread] = set()
        self._pause_epoch = 0       # bumped by every pause(): "went dark"
        self.last_reshard: Optional[ReshardReport] = None
        self.reshards: List[ReshardReport] = []

    @property
    def checkpoint_path(self) -> str:
        """Checkpoint Pause-and-Resume reloads from; written lazily so the
        many pools a benchmark sweep builds don't each serialize the model."""
        if self._checkpoint_path is None:
            fd, path = tempfile.mkstemp(suffix=".npz")
            os.close(fd)
            from repro_torch.checkpoint import save_pytree
            save_pytree(self.runner.params, path)
            self._checkpoint_path = path
        return self._checkpoint_path

    @property
    def executor(self) -> BuildExecutor:
        """Lazily-started background build worker."""
        with self._lock:
            if self._executor is None:
                self._executor = BuildExecutor()
            return self._executor

    # -- keys --------------------------------------------------------------
    def make_key(self, split: int, *, owns_weights: bool = False,
                 mesh_shape=_UNSET, variant: str = "") -> PipelineKey:
        """The key a build for ``split`` targets *right now*: unless the
        caller pins one, ``mesh_shape`` defaults to the pool's current
        target mesh — which is how every strategy becomes mesh-aware
        without knowing meshes exist."""
        if mesh_shape is _UNSET:
            with self._lock:
                mesh_shape = self.mesh_shape
        return PipelineKey(split=int(split), owns_weights=bool(owns_weights),
                           mesh_shape=mesh_shape, variant=variant)

    def _coerce_key(self, key, owns_weights: bool = False,
                    mesh_shape=_UNSET) -> PipelineKey:
        """Accept a PipelineKey, a legacy tuple (deprecation shim) or a
        bare split int (+ the keyword flags) uniformly."""
        if isinstance(key, PipelineKey):
            return key
        if isinstance(key, tuple):
            return PipelineKey.of(key)
        return self.make_key(int(key), owns_weights=owns_weights,
                             mesh_shape=mesh_shape)

    def set_mesh_shape(self, mesh_shape: Optional[Tuple[int, ...]]) -> None:
        """Retarget NEW builds to a different cloud mesh (device gained or
        lost).  Existing entries keep their shapes; the next repartition's
        activation performs the measured reshard."""
        with self._lock:
            self.mesh_shape = (tuple(int(d) for d in mesh_shape)
                               if mesh_shape is not None else None)

    # -- bookkeeping -------------------------------------------------------
    def __contains__(self, key) -> bool:
        key = self._coerce_key(key)
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> Iterator[PipelineKey]:
        with self._lock:
            return iter(list(self._entries))

    def has(self, key, owns_weights: bool = False) -> bool:
        key = self._coerce_key(key, owns_weights)
        with self._lock:
            e = self._entries.get(key)
            return e is not None and e.pipeline.ready

    def get(self, key) -> Optional[PoolEntry]:
        key = self._coerce_key(key)
        with self._lock:
            return self._entries.get(key)

    def _touch(self, entry: PoolEntry) -> None:
        with self._lock:
            self._clock += 1
            entry.last_used = self._clock

    @property
    def active(self):
        with self._lock:
            e = self._entries.get(self.active_key) if self.active_key \
                else None
            return e.pipeline if e else None

    def snapshot_active(self) -> Optional[PoolEntry]:
        """Atomic read of the active entry for request admission.

        The serving engine's admission hot path must never observe a
        half-switched pool: the key lookup, entry resolution and LRU touch
        happen under the pool lock, the same lock ``activate`` swaps the
        pointer under.  The returned entry stays alive for the admitted
        request even if a switch replaces it immediately afterwards —
        eviction never reaps the active entry, and a pointer swap only
        *changes* which entry that is, so the snapshot's pipeline remains
        built until the pool explicitly releases it (in-flight requests
        drain on the old pipeline).
        """
        with self._lock:
            if self.active_key is None:
                return None
            e = self._entries.get(self.active_key)
            if e is not None:
                self._touch(e)
            return e

    @property
    def standby(self):
        with self._lock:
            e = self._entries.get(self.standby_key) if self.standby_key \
                else None
            return e.pipeline if e else None

    @property
    def standby_attempted(self) -> bool:
        """True once any standby build was started (landed or in flight).

        The locked accessor strategies use instead of peeking at
        ``_standby_handle``/``standby_key`` directly.
        """
        with self._lock:
            return self._standby_handle is not None \
                or self.standby_key is not None

    def set_network(self, net: NetworkModel) -> None:
        with self._lock:
            self.net = net
            for e in self._entries.values():
                e.pipeline.net = net

    # -- build / reuse -----------------------------------------------------
    def _new_pipeline(self, key: PipelineKey) -> EdgeCloudPipeline:
        """Pipeline construction hook (stateful pools build
        ``StatefulEdgeCloudPipeline``s against their shared session)."""
        return EdgeCloudPipeline(self.runner, key.split, self.net,
                                 owns_weights=key.owns_weights,
                                 mesh_shape=key.mesh_shape)

    def ensure(self, key, *, owns_weights: bool = False,
               cold: bool = False, reload_from: Optional[str] = None,
               reuse: bool = True) -> Tuple[PoolEntry, bool]:
        """Return a ready pipeline for a ``PipelineKey`` (or a bare split
        int + ``owns_weights``, which keys against the pool's current
        target mesh).

        ``reuse=True`` returns a cached entry when present (warm hit,
        zero build cost — what ``switch_pool`` exploits); ``reuse=False``
        rebuilds even if cached, which is what the paper's B strategies
        mean by t_init / t_exec.  Returns ``(entry, cache_hit)``.

        Safe to call from the build worker: the (long) compile runs
        outside the pool lock; only the entry insertion is serialized.
        """
        key = self._coerce_key(key, owns_weights)
        if reuse:
            with self._lock:
                cached = self._entries.get(key)
                if cached is not None and cached.pipeline.ready:
                    self._touch(cached)
                    return cached, True
        plan = self.fault_plan
        if plan is not None:
            # chaos valve: may raise InjectedBuildFailure or stall.
            # Outside the pool lock, like the build it gates.
            plan.on_build(key)
        pipe = self._new_pipeline(key)
        report = pipe.build(self.sample_inputs, cold=cold,
                            reload_from=reload_from)
        with self._lock:
            # the link may have changed while this pipeline was built off
            # the lock: ``set_network`` reached only the entries that had
            # landed, so the new one takes the pool's link as it lands
            pipe.net = self.net
            replaced = self._entries.get(key)
            if replaced is not None:
                # rebuilding the active key orphans the old active object the
                # moment the dict entry is swapped (``self.active`` resolves
                # through ``_entries``), so it must be closed either way —
                # keeping it alive was a leak
                replaced.pipeline.close()
            entry = PoolEntry(key, pipe, report)
            self._entries[key] = entry
            self._touch(entry)
            # never evict the entry we were asked for — callers may be about
            # to activate it; speculative builders re-run evict_to_budget()
            # themselves
            self.evict_to_budget(keep=key)
            self._evict_over_capacity(keep=key)
        return entry, False

    def resolve_standby_ownership(self, owns_weights: Optional[bool]) -> bool:
        """None -> the pool's configured standby default."""
        return self.standby_owns_weights if owns_weights is None \
            else owns_weights

    def build_standby(self, split: int,
                      owns_weights: Optional[bool] = None) -> float:
        """(Re)build the Scenario-A standby; returns wall-clock build time
        (the ``standby_build`` span's)."""
        ow = self.resolve_standby_ownership(owns_weights)
        with timing.timed("standby_build", split=split) as sp:
            self._build_standby(split, ow)
        return sp.wall

    def _build_standby(self, split: int, owns_weights: bool) -> None:
        entry, _ = self.ensure(self.make_key(split, owns_weights=owns_weights),
                               cold=owns_weights, reuse=False)
        with self._lock:
            # arm the standby BEFORE warming: eviction treats the standby
            # as the last resort, so a concurrently-landing build's budget
            # pass won't close the pipeline mid-warm
            self.standby_key = entry.key
        if self.warm_standbys:
            entry.pipeline.warm(self.sample_inputs)

    # -- background builds -------------------------------------------------
    def pending(self, key, owns_weights: bool = False
                ) -> Optional[BuildHandle]:
        """The in-flight build handle for a key, if any."""
        key = self._coerce_key(key, owns_weights)
        with self._lock:
            return self._pending.get(key)

    def pending_builds(self) -> int:
        """Background builds submitted and not landed yet."""
        with self._lock:
            return len(self._pending)

    def submit_build(self, key, *, owns_weights: bool = False,
                     cold: bool = False, reuse: bool = True,
                     standby: bool = False, enforce_budget: bool = False,
                     on_done: Optional[Callable[[BuildHandle], None]] = None
                     ) -> BuildHandle:
        """Queue a build on the background worker; returns immediately.

        Duplicate submissions for a key already in flight coalesce onto the
        existing handle (the first submission's build mode wins, but a
        coalesced ``standby=True`` still arms the standby when the build
        lands).  ``on_done`` fires only for a build this call actually
        created, so per-switch background accounting never double-counts a
        shared build.  ``standby=True`` marks the result as the Scenario-A
        standby; ``enforce_budget=True`` re-runs ``evict_to_budget()``
        after the build lands, which is the speculative builders'
        best-effort contract.
        """
        key = self._coerce_key(key, owns_weights)
        with self._lock:
            existing = self._pending.get(key)
            if existing is not None:
                if standby:
                    self._standby_handle = existing

                    def _mark_standby(h: BuildHandle) -> None:
                        if h.error is None and h.result is not None:
                            with self._lock:
                                if h.result.key != self.active_key:
                                    self.standby_key = h.result.key

                    existing.add_done_callback(_mark_standby)
                return existing

            def job():
                with self._lock:
                    if key == self.active_key and key in self._entries:
                        # never rebuild the pipeline that is serving: the
                        # replacement close() would yank edge_fn/params out
                        # from under an in-flight process() call.  (It can
                        # become the active key between submit and run —
                        # e.g. a mismatch switch activating the standby.)
                        return self._entries[key]
                entry, hit = self.ensure(key, cold=cold, reuse=reuse)
                if standby and self.warm_standbys and not hit:
                    # "always-running" standby: absorb the first-execution
                    # spike on the worker, not on the first post-swap
                    # request (the key is pending, so eviction can't reap
                    # the entry mid-warm; a cache hit was already warmed)
                    entry.pipeline.warm(self.sample_inputs)
                with self._lock:
                    if standby and entry.key != self.active_key:
                        self.standby_key = entry.key
                    if enforce_budget:
                        # best-effort speculation may reap the entry it just
                        # built (budget-0 must not pin itself alive); only
                        # this job's own key loses its in-flight protection
                        self.evict_to_budget(reap_pending=(key,))
                return entry

            handle = self.executor.submit(
                job, key=key,
                span="standby_build" if standby else "background_build")
            self._pending[key] = handle
            if standby:
                self._standby_handle = handle

            def _finish(h: BuildHandle) -> None:
                with self._lock:
                    self._pending.pop(key, None)
                    if h.error is not None:
                        self._build_failures.append((key, h.error))

            handle.add_done_callback(_finish)
            if on_done is not None:
                handle.add_done_callback(on_done)
        return handle

    def wait(self, key, owns_weights: bool = False,
             timeout: Optional[float] = None) -> Optional[PoolEntry]:
        """Block until any in-flight build for the key lands; surface
        failures; return the entry (None if the build failed/was evicted)."""
        key = self._coerce_key(key, owns_weights)
        with self._lock:
            handle = self._pending.get(key)
        if handle is not None:
            handle.wait(timeout)
        self._surface_failures()
        with self._lock:
            return self._entries.get(key)

    def wait_standby(self, timeout: Optional[float] = None):
        """Block until an in-flight standby build (if any) lands.

        Waits on the build *handle* (which completes strictly after
        ``standby_key`` is set), so a ready standby is visible on return.
        """
        with self._lock:
            handle = self._standby_handle
        if handle is not None:
            handle.wait(timeout)
        self._surface_failures()
        return self.standby

    def drain(self, timeout: Optional[float] = None) -> None:
        """Deterministic barrier: wait for every pending build, then warn
        (on this thread) for any that failed."""
        deadline = None if timeout is None else timing.now() + timeout
        while True:
            with self._lock:
                handles = list(self._pending.values())
            if not handles:
                break
            for h in handles:
                left = None if deadline is None \
                    else max(0.0, deadline - timing.now())
                if not h.wait(left) and deadline is not None:
                    break
            if deadline is not None and timing.now() >= deadline:
                break
        self._surface_failures()

    def close(self) -> None:
        """End-of-life: settle background work and stop the worker thread.

        Benchmark sweeps build one pool per strategy; without this each
        pool would leave an idle daemon worker (and its job closures'
        references) alive for the life of the process.
        """
        self.drain()
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown()

    def _surface_failures(self) -> None:
        with self._lock:
            failures, self._build_failures = self._build_failures, []
        for key, err in failures:
            warnings.warn(f"background build for {key} failed: {err!r}; "
                          f"service continues on the previous pipeline",
                          BackgroundBuildFailed)

    # -- activation / teardown ---------------------------------------------
    def activate(self, key) -> float:
        """Atomic pointer swap to an already-built pipeline; returns t_switch.

        Atomic w.r.t. in-flight admission: the swap happens under the same
        lock ``snapshot_active`` reads under, so the serving engine either
        admits against the old pipeline (and drains on it) or against the
        new one — never a torn state.

        When the incoming entry's ``mesh_shape`` differs from the outgoing
        active's (a repartition that also gained/lost cloud devices), the
        mesh transition is executed here: ``pipeline.reshard()`` places
        whatever is not already on the target placement, measured on the
        stream and recorded as ``last_reshard`` for the switch owner to
        stamp onto its ``SwitchReport``.  (Stateful pools hand the decode
        state across the moved split first, in their override, and their
        pipelines' ``reshard`` moves the live decode state too.)"""
        key = self._coerce_key(key)
        with self._lock:
            self._check_fence()
            entry = self._entries[key]
            assert entry.pipeline.ready, f"pipeline {key} not built"
            old_key = self.active_key if self.active_key is not None \
                else self._paused_key
            reshard = None
            with timing.timed("switch.activate") as act:
                if old_key is not None \
                        and old_key.mesh_shape != key.mesh_shape:
                    with timing.timed("switch.reshard") as rsp:
                        moved = entry.pipeline.reshard()
                    reshard = ReshardReport(old_mesh=old_key.mesh_shape,
                                            new_mesh=key.mesh_shape,
                                            t_wall=rsp.wall,
                                            moved_bytes=moved)
                self.active_key = key
                self._paused_key = None
            t_switch = act.wall
            if self.standby_key == key:
                self.standby_key = None
            if reshard is not None:
                self.last_reshard = reshard
                self.reshards.append(reshard)
            self._touch(entry)
        return t_switch

    def take_last_reshard(self) -> Optional[ReshardReport]:
        """Pop the reshard executed by the most recent activation (None if
        the last switch kept the mesh shape): the same single-consumer
        contract as the stateful pool's ``take_last_handoff``."""
        with self._lock:
            reshard, self.last_reshard = self.last_reshard, None
            return reshard

    def try_activate(self, key) -> Optional[float]:
        """``activate`` that returns None instead of raising when the key
        vanished (a concurrently-landing build's eviction can reap a
        non-active entry between a caller's readiness check and the swap)."""
        key = self._coerce_key(key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or not entry.pipeline.ready:
                return None
            return self.activate(key)

    def pause(self) -> Optional[PipelineKey]:
        """Stop serving (Pause-and-Resume step ii); returns the old key."""
        with self._lock:
            self._check_fence()
            old, self.active_key = self.active_key, None
            # remember what WAS serving: the resume-side activation hands
            # state off from it and detects a mesh-shape change across the
            # dark window
            if old is not None:
                self._paused_key = old
            self._pause_epoch += 1
        return old

    # -- watchdog fencing ---------------------------------------------------
    # The serving engine's switch watchdog runs a strategy's switch() on a
    # sacrificial thread.  On timeout it *fences* that thread: any further
    # pool mutation (activate/pause) from it raises SwitchAborted, so a
    # zombie switch that eventually unblocks cannot yank the pointer out
    # from under the rolled-back engine.  Fencing takes the pool lock,
    # which linearizes it against an in-flight activate: either the swap
    # completed first (watchdog sees it in the grace re-check) or the
    # fence lands first and the swap raises.

    @property
    def pause_epoch(self) -> int:
        """How many times serving was paused — the engine's ''did the
        aborted switch go dark before we fenced it'' signal."""
        with self._lock:
            return self._pause_epoch

    def fence_thread(self, thread: Optional[threading.Thread] = None) -> None:
        """Fence by Thread *object*, not ident: idents are recycled after
        a thread dies, and a recycled ident must not inherit a fence."""
        if thread is None:
            thread = threading.current_thread()
        with self._lock:
            # drop fences whose zombie already exited (bounded growth)
            self._aborted_switch_threads = {
                t for t in self._aborted_switch_threads if t.is_alive()}
            self._aborted_switch_threads.add(thread)

    def unfence_thread(self, thread: Optional[threading.Thread] = None) -> None:
        if thread is None:
            thread = threading.current_thread()
        with self._lock:
            self._aborted_switch_threads.discard(thread)

    def _check_fence(self) -> None:    # holds: _lock
        if threading.current_thread() in self._aborted_switch_threads:
            raise SwitchAborted("this switch was abandoned by the watchdog; "
                                "its pool mutations are fenced off")

    def release(self, key) -> None:
        key = self._coerce_key(key)
        with self._lock:
            if key == self.active_key:
                raise ValueError("cannot release the active pipeline")
            if key in self._pending:
                raise ValueError(f"cannot release {key}: build in flight")
            self._release(key)

    def _release(self, key: PoolKey) -> None:
        """Teardown without the in-flight guard (internal eviction paths
        perform their own pending checks)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return
            if self.standby_key == key:
                self.standby_key = None
            entry.pipeline.close()

    # -- memory accounting (Table I) ---------------------------------------
    def additional_bytes(self) -> int:
        with self._lock:
            return sum(e.charged_bytes for k, e in self._entries.items()
                       if k != self.active_key)

    def evict_to_budget(self, keep: Optional[PoolKey] = None, *,
                        reap_pending: Tuple[PoolKey, ...] = ()
                        ) -> List[PoolKey]:
        """Drop LRU non-active entries until charged bytes fit the budget.

        ``keep`` protects one key (a just-built entry a caller is about to
        activate); keys with a build in flight are never reaped unless
        explicitly listed in ``reap_pending`` (a background job releasing
        its own just-landed entry).  Either may leave the pool transiently
        over budget.
        """
        if self.mem_budget_bytes is None:
            return []
        evicted: List[PoolKey] = []
        with self._lock:
            while self.additional_bytes() > self.mem_budget_bytes:
                victims = sorted(
                    (e for k, e in self._entries.items()
                     if k != self.active_key and k != keep
                     and (k not in self._pending or k in reap_pending)
                     and e.charged_bytes > 0),
                    # nk: allow[NK01]: sorted() runs the lambda under _lock
                    key=lambda e: (e.key == self.standby_key, e.last_used))
                if not victims:
                    if keep is None and not self._pending:
                        warnings.warn("pipeline pool over memory budget but "
                                      "nothing evictable", RuntimeWarning)
                    break
                self._release(victims[0].key)
                evicted.append(victims[0].key)
        return evicted

    def _evict_over_capacity(self, keep: Optional[PoolKey] = None) -> None:
        """Bound the entry count: even 0-charged (shared-weight) entries hold
        compiled executables, so a long-running deployment visiting many
        splits must not grow the pool without limit."""
        if self.max_entries is None:
            return
        with self._lock:
            while len(self._entries) > self.max_entries:
                victims = sorted(
                    (e for k, e in self._entries.items()
                     if k not in (self.active_key, self.standby_key, keep)
                     and k not in self._pending),
                    key=lambda e: e.last_used)
                if not victims:
                    break
                self._release(victims[0].key)

    def memory_report(self) -> Dict[str, int]:
        base = self.active.live_param_bytes() if self.active else 0
        extra = self.additional_bytes()
        return {"initial_bytes": base, "additional_bytes": extra,
                "total_bytes": base + extra}
