"""SwitchStrategy registry: the paper's scenarios as a pluggable space.

The port's copy of ``repro/core/strategies.py``, logic unchanged.  It keeps
its own registry: the registrations repeat the reference's names, which
the registry lint (NK04) allows inline.

A strategy is a class registered under a name::

    @register_strategy("my_strategy")
    class MyStrategy(SwitchStrategy):
        def switch(self, pool, new_split) -> SwitchReport: ...

and resolved by spec string — either a bare name (``"switch_b2"``) or a
parameterised form (``"switch_pool(k=2)"``).  Controllers, benchmarks and
examples iterate ``available_strategies()`` / ``benchmark_specs()``, so a
new strategy needs no edits anywhere else.

Strategy -> paper mechanism (all operate against a PipelinePool):

``pause_resume``  (baseline, Eq. 2: t_downtime = t_update)
    Pause serving, cold-rebuild from the checkpoint, resume.  Full outage.

``switch_a``  (Scenario A, Eq. 3: t_downtime = t_switch)
    Swap to the always-running standby; rebuild a standby for the old
    configuration in the background.

``switch_b1``  (Scenario B Case 1, Eq. 4: t_downtime = t_init + t_switch)
    Cold build of a new container (own weights) while the old pipeline
    keeps serving, then redirect.

``switch_b2``  (Scenario B Case 2, Eq. 5: t_downtime = t_exec + t_switch)
    Warm build inside the existing container (shared weights, jit cache).

``switch_pool``  (beyond-paper: tunable memory/downtime trade-off)
    Keep the top-k splits predicted from the recent bandwidth trend
    pre-built in the pool.  A predicted switch is a pointer swap
    (Scenario-A downtime at (1+k)x memory); a miss falls back to the
    B-Case-2 warm build.  k=0 degenerates to B2, k=1 to A Case 1.

Async lifecycle (overlapped switching).  Strategy hooks are: ``prepare``
once before serving (pre-position standbys — synchronous, deterministic),
``observe`` on every network sample (feed prediction), ``switch`` per
repartition, and implicit *background drain*: ``switch_a``'s standby
rebuild and ``switch_pool``'s speculation are submitted to the pool's
``BuildExecutor`` and ``switch()`` returns right after the pointer swap.
Every ``SwitchReport`` therefore separates

* ``t_blocked``      — serving-thread time spent inside ``switch()``
  (downtime + any synchronous waiting), and
* ``t_background_wall`` — wall time the build worker spent afterwards,
  filled in asynchronously once the background build lands (read it after
  ``pool.drain()`` / ``PipelineManager.drain()``).

If a switch targets a key whose speculative build is still in flight, the
strategy *awaits that build* instead of duplicating it (a "wait-hit").

Strategies are session-agnostic: when the pool carries decode state (one
``DecodeSession`` or a multi-session ``SessionManager`` slot pool), the
state hand-off — whole-batch export/import or masked recompute, chosen
per ``plan_handoff`` — happens inside the pool's activation step, so
every strategy above moves N concurrent sessions as one payload with no
strategy-side changes.
"""
from __future__ import annotations

import ast
import collections
import re
import warnings
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import timing
from repro_torch.core.network import NetworkModel
from repro_torch.core.partitioner import optimal_split
from repro_torch.core.pipeline import BuildReport
from repro_torch.core.pool import PipelinePool


@dataclass
class SwitchReport:
    strategy: str
    old_split: int
    new_split: int
    downtime: float               # the paper's t_downtime for this strategy
    t_build: float = 0.0          # t_update / t_init / t_exec component
    t_switch: float = 0.0
    full_outage: bool = False     # True only for pause_resume
    background_cost: float = 0.0  # e.g. standby rebuild after switch_a
    build_detail: Optional[BuildReport] = None
    cache_hit: bool = False       # switch landed on a pre-built pipeline
    note: str = ""                # surfaced anomalies (e.g. standby mismatch)
    t_blocked: float = 0.0        # serving-thread time spent inside switch()
    t_background_wall: float = 0.0  # worker wall time for deferred builds;
                                    # filled in async — read after drain()
    # stateful pipelines only (see repro.core.stateful): the executed
    # KV/SSM state hand-off the switch's activation performed
    t_handoff: float = 0.0        # measured wall + priced link seconds
    handoff_bytes: int = 0        # really-serialized bytes (transfer arm)
    handoff_mode: str = ""        # 'transfer' | 'recompute' | 'none'
    aborted: bool = False         # watchdog timed the switch out and the
                                  # engine rolled back to the old pipeline
    # mesh-shape-changing repartitions only: the weight/state resharding
    # the activation executed on the stream.  Its wall is already inside
    # ``t_switch`` (activate measures the swap + reshard as one span);
    # recorded separately so benchmarks can attribute it
    t_reshard: float = 0.0
    old_mesh: Optional[Tuple[int, ...]] = None
    new_mesh: Optional[Tuple[int, ...]] = None

    @property
    def mesh_change(self) -> bool:
        return self.old_mesh != self.new_mesh


class StandbySplitMismatch(UserWarning):
    """Scenario A was asked for a split its standby was not built for."""


def apply_handoff(pool: "PipelinePool", report: SwitchReport):
    """Stamp the state hand-off a stateful pool executed during this
    switch's activation onto the report.

    Stateless pools have no ``take_last_handoff`` and are a no-op.  The
    hand-off's measured WALL is already inside every strategy's own
    downtime accounting (the stateful pool folds it into the ``t_switch``
    its ``activate`` returns, and pause_resume's outage timer wraps the
    activation outright), so only the PRICED link seconds — virtual time
    no on-thread timer can see — are added to ``report.downtime`` here.
    Called once per switch by the two switch owners
    (``PipelineManager.repartition`` and ``ServingEngine.execute_switch``);
    popping the hand-off keeps the stamp idempotent.

    Also stamps the mesh reshard (``pool.take_last_reshard``) the same
    way: its wall is already inside the strategy's ``t_switch`` (the
    activation measured swap + reshard as one span), so nothing is added
    to ``downtime`` — the fields only attribute the cost."""
    take_reshard = getattr(pool, "take_last_reshard", None)
    if take_reshard is not None:
        reshard = take_reshard()
        if reshard is not None:
            report.t_reshard = reshard.t_wall
            report.old_mesh = reshard.old_mesh
            report.new_mesh = reshard.new_mesh
    take = getattr(pool, "take_last_handoff", None)
    if take is None:
        return None
    handoff = take()
    if handoff is None:
        return None
    report.t_handoff = handoff.total
    report.handoff_bytes = handoff.moved_bytes
    report.handoff_mode = handoff.mode
    report.downtime += handoff.t_network
    return handoff


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_SPEC_RE = re.compile(r"^\s*([A-Za-z_]\w*)\s*(?:\((.*)\))?\s*$")


class Registry:
    """Name -> class registry resolved by spec string.

    One implementation of the ``@register_*`` pattern, shared by the
    switch strategies here, the repartition policies
    (``repro.core.controller.POLICIES``) and the arrival processes
    (``repro.serving.workload.ARRIVALS``): register classes under a name,
    resolve instances from ``"name"`` / ``"name(k=2)"`` spec strings, and
    pass pre-built instances through untouched.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, type] = {}
        # expected base class for instance pass-through (assigned after
        # the base class exists, e.g. STRATEGIES.base = SwitchStrategy):
        # catches get_policy(some_strategy)-style mixups at resolution
        # time instead of as an opaque AttributeError much later
        self.base: Optional[type] = None

    def register(self, name: str, *, override: bool = False):
        """Class decorator adding ``cls`` to the registry as ``name``."""
        def deco(cls):
            if name in self._items and not override:
                raise ValueError(f"{self.kind} {name!r} already registered "
                                 f"(pass override=True to replace)")
            cls.name = name
            self._items[name] = cls
            return cls
        return deco

    def unregister(self, name: str) -> None:
        self._items.pop(name, None)

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def cls(self, name: str) -> type:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; registered: "
                           f"{self.names()}") from None

    def resolve(self, spec, **overrides):
        """Instantiate from a spec string, or pass an instance through."""
        if not isinstance(spec, str):
            if self.base is not None and not isinstance(spec, self.base):
                raise TypeError(f"expected a {self.kind} spec string or "
                                f"{self.base.__name__} instance, got "
                                f"{type(spec).__name__}")
            return spec
        name, kwargs = parse_spec(spec)
        kwargs.update(overrides)
        return self.cls(name)(**kwargs)


STRATEGIES = Registry("strategy")


def register_strategy(name: str, *, override: bool = False):
    """Class decorator adding a SwitchStrategy to the registry."""
    return STRATEGIES.register(name, override=override)


def unregister_strategy(name: str) -> None:
    STRATEGIES.unregister(name)


def available_strategies() -> List[str]:
    return STRATEGIES.names()


def strategy_class(name: str) -> type:
    return STRATEGIES.cls(name)


def parse_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``"switch_pool(k=2)"`` -> ``("switch_pool", {"k": 2})``.

    Args are parsed as Python keyword literals, so compound values work
    too: ``"my_strat(splits=(1, 2), label='a,b')"``.
    """
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(f"malformed strategy spec {spec!r}")
    name, argstr = m.groups()
    kwargs: Dict[str, Any] = {}
    if argstr and argstr.strip():
        try:
            call = ast.parse(f"_spec({argstr})", mode="eval").body
        except SyntaxError:
            raise ValueError(f"malformed strategy args {argstr!r}") from None
        if call.args or any(kw.arg is None for kw in call.keywords):
            raise ValueError(f"strategy args must be key=value: {argstr!r}")
        try:
            kwargs = {kw.arg: ast.literal_eval(kw.value)
                      for kw in call.keywords}
        except ValueError:
            raise ValueError(f"strategy args must be literals: "
                             f"{argstr!r}") from None
    return name, kwargs


def get_strategy(spec: Union[str, "SwitchStrategy"],
                 **overrides) -> "SwitchStrategy":
    """Resolve a spec string (or pass through an instance)."""
    return STRATEGIES.resolve(spec, **overrides)


def benchmark_specs() -> List[str]:
    """Every registered strategy's benchmark variants (deduped, ordered)."""
    out: List[str] = []
    for name in available_strategies():
        for v in STRATEGIES.cls(name).benchmark_variants():
            if v not in out:
                out.append(v)
    return out


# ---------------------------------------------------------------------------
# base class
# ---------------------------------------------------------------------------

class SwitchStrategy:
    """One point in the repartitioning strategy space.

    Lifecycle: ``prepare`` once (pre-position standbys), ``observe`` on
    every network sample (feed prediction), ``switch`` per repartition.
    """

    name: ClassVar[str] = "?"

    @property
    def spec(self) -> str:
        return self.name

    @classmethod
    def benchmark_variants(cls) -> Sequence[str]:
        """Spec strings the benchmark suite should sweep for this strategy."""
        return (cls.name,)

    def prepare(self, pool: PipelinePool,
                candidate_splits: Sequence[int] = ()) -> None:
        """Pre-position pipelines before serving starts (optional)."""

    def observe(self, pool: PipelinePool, net: Optional[NetworkModel] = None,
                profile=None) -> None:
        """Feed a network sample / model profile for prediction (optional)."""

    def switch(self, pool: PipelinePool, new_split: int) -> SwitchReport:
        raise NotImplementedError


STRATEGIES.base = SwitchStrategy


# ---------------------------------------------------------------------------
# the paper's four strategies
# ---------------------------------------------------------------------------

@register_strategy("pause_resume")  # nk: allow[NK04]: the port's own registry
class PauseResumeStrategy(SwitchStrategy):
    """Baseline: halt, cold-rebuild from storage, resume (full outage)."""

    def switch(self, pool: PipelinePool, new_split: int) -> SwitchReport:
        old_key = pool.active_key
        old = pool.active.split
        ckpt = pool.checkpoint_path      # lazy write happens OUTSIDE t_update
        sw = timing.Stopwatch()
        pool.pause()                                       # (ii) pause
        try:
            entry, _ = pool.ensure(new_split, cold=True,   # (iii) update
                                   reload_from=ckpt,
                                   reuse=False)
            pool.activate(entry.key)                       # (iv) resume
        finally:
            # a failed rebuild must not strand the service in permanent
            # outage: fall back to the previous pipeline
            if pool.active is None and old_key is not None and old_key in pool:
                pool.activate(old_key)
        dt = sw.elapsed()
        return SwitchReport("pause_resume", old, new_split, downtime=dt,
                            t_build=entry.report.total, full_outage=True,
                            build_detail=entry.report, t_blocked=dt)


@register_strategy("switch_a")  # nk: allow[NK04]: the port's own registry
class ScenarioAStrategy(SwitchStrategy):
    """Always-running standby; switching is an atomic pointer swap."""

    def __init__(self, owns_weights: Optional[bool] = None):
        self.owns_weights = owns_weights   # None -> pool default

    def prepare(self, pool: PipelinePool,
                candidate_splits: Sequence[int] = ()) -> None:
        active_split = pool.active.split if pool.active is not None else None
        for s in candidate_splits:
            if s != active_split:
                pool.build_standby(s, owns_weights=self.owns_weights)
                return

    def switch(self, pool: PipelinePool, new_split: int) -> SwitchReport:
        sw_blocked = timing.Stopwatch()
        standby = pool.standby
        if standby is None or not standby.ready:
            # a previous switch's standby rebuild may still be in flight —
            # await it rather than failing (counts toward t_blocked)
            standby = pool.wait_standby()
        if standby is None or not standby.ready:
            if pool.standby_attempted:
                # the background rebuild failed (already surfaced as a
                # BackgroundBuildFailed warning): availability wins over
                # the Scenario-A mechanism — degrade to a B2-style warm
                # build instead of taking the service down
                return self._degraded_switch(pool, new_split, sw_blocked)
            raise RuntimeError(
                "Scenario A requires the always-running standby pipeline")
        old = pool.active.split
        note = ""
        requested = new_split
        if standby.split != new_split:
            # Scenario A can only jump to the configuration it pre-built;
            # surface the mismatch instead of silently rewriting the target.
            note = (f"standby built for split {standby.split}, requested "
                    f"{new_split}; switching to the standby")
            warnings.warn(note, StandbySplitMismatch)
            new_split = standby.split
        t_switch = pool.try_activate(pool.standby_key)     # atomic swap
        if t_switch is None:
            # the standby was reaped between the readiness check and the
            # swap (concurrent build landing + eviction): keep serving
            return self._degraded_switch(pool, requested, sw_blocked)
        rep = SwitchReport("switch_a", old, new_split, downtime=t_switch,
                           t_switch=t_switch, cache_hit=True, note=note)
        # background: rebuild the redundant pipeline for the *old* config on
        # the build worker — the serving thread returns after the swap
        ow = pool.resolve_standby_ownership(self.owns_weights)

        def _done(handle):
            rep.background_cost = handle.t_wall
            rep.t_background_wall = handle.t_wall

        pool.submit_build(old, owns_weights=ow, cold=ow, reuse=False,
                          standby=True, on_done=_done)
        rep.t_blocked = sw_blocked.elapsed()
        return rep

    def _degraded_switch(self, pool: PipelinePool, new_split: int,
                         sw_blocked: timing.Stopwatch) -> SwitchReport:
        """Availability fallback when a standby rebuild ever ran but its
        result is unusable (failed, or evicted under memory pressure).
        Never-configured stays a hard error in ``switch``: it is a
        deployment mistake, not a runtime condition."""
        old = pool.active.split
        note = ("standby unavailable (failed background rebuild or evicted "
                "mid-switch); fell back to a warm build")
        warnings.warn(note, StandbySplitMismatch)
        sw = timing.Stopwatch()
        entry, _ = pool.ensure(new_split, owns_weights=False, cold=False)
        t_build = sw.elapsed()
        t_switch = pool.activate(entry.key)
        ow = pool.resolve_standby_ownership(self.owns_weights)
        pool.submit_build(old, owns_weights=ow, cold=ow, reuse=False,
                          standby=True)           # try to restore Scenario A
        rep = SwitchReport("switch_a", old, new_split,
                           downtime=t_build + t_switch, t_build=t_build,
                           t_switch=t_switch, build_detail=entry.report,
                           note=note)
        rep.t_blocked = sw_blocked.elapsed()
        return rep


@register_strategy("switch_b1")  # nk: allow[NK04]: the port's own registry
class ScenarioB1Strategy(SwitchStrategy):
    """Cold build of a new container while the old one serves, then redirect."""

    def switch(self, pool: PipelinePool, new_split: int) -> SwitchReport:
        old_key = pool.active_key
        old = pool.active.split
        sw = timing.Stopwatch()
        entry, _ = pool.ensure(new_split, owns_weights=True, cold=True,
                               reuse=False)                # new container
        t_build = sw.elapsed()
        t_switch = pool.activate(entry.key)                # redirect
        if old_key is not None and old_key != entry.key:
            pool.release(old_key)                          # reap old container
        return SwitchReport("switch_b1", old, new_split,
                            downtime=t_build + t_switch, t_build=t_build,
                            t_switch=t_switch, build_detail=entry.report,
                            t_blocked=t_build + t_switch)


@register_strategy("switch_b2")  # nk: allow[NK04]: the port's own registry
class ScenarioB2Strategy(SwitchStrategy):
    """Warm build inside the existing container (jit cache, shared weights)."""

    def switch(self, pool: PipelinePool, new_split: int) -> SwitchReport:
        old = pool.active.split
        sw = timing.Stopwatch()
        entry, _ = pool.ensure(new_split, owns_weights=False, cold=False,
                               reuse=False)                # same container
        t_build = sw.elapsed()
        t_switch = pool.activate(entry.key)
        return SwitchReport("switch_b2", old, new_split,
                            downtime=t_build + t_switch, t_build=t_build,
                            t_switch=t_switch, build_detail=entry.report,
                            t_blocked=t_build + t_switch)


# ---------------------------------------------------------------------------
# beyond-paper: speculative pre-building, k pipelines deep
# ---------------------------------------------------------------------------

@register_strategy("switch_pool")  # nk: allow[NK04]: the port's own registry
class SwitchPoolStrategy(SwitchStrategy):
    """Keep the top-k predicted splits pre-built: A's downtime when the
    prediction hits, B2's when it misses, at (1+k)x memory.

    Prediction uses the bandwidth trend (linear extrapolation plus recent
    levels mapped through the Eq.-1 optimiser) when a profile is available,
    falling back to the recently-active splits otherwise.
    """

    def __init__(self, k: int = 1, owns_weights: bool = True,
                 history: int = 8):
        self.k = int(k)
        self.owns_weights = bool(owns_weights)
        self._bw_hist: collections.deque = collections.deque(maxlen=history)
        self._split_hist: collections.deque = collections.deque(maxlen=history)
        self._profile = None
        # optimal_split memo per bandwidth, valid for one profile object
        self._split_memo: Dict[float, int] = {}
        self._split_memo_profile = None

    @property
    def spec(self) -> str:
        return f"switch_pool(k={self.k})"

    @classmethod
    def benchmark_variants(cls) -> Sequence[str]:
        return ("switch_pool(k=0)", "switch_pool(k=1)", "switch_pool(k=2)")

    def prepare(self, pool: PipelinePool,
                candidate_splits: Sequence[int] = ()) -> None:
        """Seed the predictor with the deployment's known operating points
        and pre-build the top-k of them (the Scenario-A warm start)."""
        for s in candidate_splits:
            if s not in self._split_hist:
                self._split_hist.append(s)
        self._speculate(pool)

    def observe(self, pool: PipelinePool, net: Optional[NetworkModel] = None,
                profile=None) -> None:
        if profile is not None:
            self._profile = profile
        if net is not None:
            self._bw_hist.append(net.bandwidth_mbps)

    def _optimal_split_memo(self, bw: float) -> int:
        """Memoised Eq.-1 optimum per bandwidth level.

        Network traces revisit the same few levels constantly, so the
        speculation hot path must not re-solve Eq. 1 on every switch.  The
        memo is keyed to the profile's ``cache_token()`` (object identity +
        invalidation version + unit count): a new profile from ``observe``,
        an ``invalidate_cache()`` after in-place edits, or a structural
        change all invalidate it wholesale.
        """
        token = self._profile.cache_token() \
            if hasattr(self._profile, "cache_token") else id(self._profile)
        if token != self._split_memo_profile:
            self._split_memo.clear()
            self._split_memo_profile = token
        split = self._split_memo.get(bw)
        if split is None:
            split = optimal_split(self._profile, NetworkModel(bw)).split
            self._split_memo[bw] = split
        return split

    def predicted_splits(self, pool: PipelinePool) -> List[int]:
        """Top-k candidate splits, most likely first."""
        cur = pool.active.split if pool.active is not None else None
        cands: List[int] = []

        def add(s):
            if s is not None and s != cur and s not in cands:
                cands.append(s)

        if self._profile is not None and self._bw_hist:
            bws = list(self._bw_hist)
            guesses = []
            if len(bws) >= 2:                     # linear bandwidth trend
                guesses.append(max(0.1, 2.0 * bws[-1] - bws[-2]))
            guesses.extend(reversed(bws))         # recent levels, newest first
            for bw in guesses:
                add(self._optimal_split_memo(bw))
        for s in reversed(self._split_hist):      # recently-served splits
            add(s)
        return cands[:self.k]

    def switch(self, pool: PipelinePool, new_split: int) -> SwitchReport:
        sw_blocked = timing.Stopwatch()
        old = pool.active.split
        if pool.net is not None:
            bw = pool.net.bandwidth_mbps
            # observe() may already have recorded this sample; a duplicate
            # would flatten the linear-trend extrapolation
            if not self._bw_hist or self._bw_hist[-1] != bw:
                self._bw_hist.append(bw)
        key = pool.make_key(new_split, owns_weights=self.owns_weights)
        hit, t_build, detail, note = False, 0.0, None, ""
        if pool.has(key):
            # predicted: pointer swap (guarded — a concurrently-landing
            # build's eviction may reap the entry before the swap)
            t_switch = pool.try_activate(key)
            if t_switch is not None:
                hit = True
                downtime = t_switch
        if not hit and pool.pending(key) is not None:
            # the speculative build for exactly this key is in flight:
            # await it instead of duplicating the work
            sw = timing.Stopwatch()
            entry = pool.wait(key)
            t_build = sw.elapsed()
            if entry is not None:
                t_switch = pool.try_activate(entry.key)
                if t_switch is not None:
                    hit = True
                    note = "awaited in-flight speculative build"
                    detail = entry.report
                    downtime = t_build + t_switch
        if not hit:                               # miss: B2-style warm build
            sw = timing.Stopwatch()
            entry, _ = pool.ensure(new_split, owns_weights=False,
                                   cold=False, reuse=False)
            t_build += sw.elapsed()
            t_switch = pool.activate(entry.key)
            detail = entry.report
            downtime = t_build + t_switch
        self._split_hist.append(old)
        rep = SwitchReport(self.spec, old, new_split, downtime=downtime,
                           t_build=t_build, t_switch=t_switch,
                           build_detail=detail, cache_hit=hit, note=note)
        self._speculate(pool, rep)
        rep.t_blocked = sw_blocked.elapsed()
        return rep

    def _speculate(self, pool: PipelinePool,
                   report: Optional[SwitchReport] = None) -> None:
        """Queue speculative pre-builds on the build worker; drop stale
        speculation.  Build wall time lands on ``report.t_background_wall``
        once each job completes (deterministically after ``pool.drain()``)."""
        want = self.predicted_splits(pool)
        for key in pool.keys():
            # stale = not wanted anymore, or built for a mesh shape the
            # pool no longer targets (a set_mesh_shape retarget obsoletes
            # old-mesh speculation)
            stale = key.split not in want \
                or key != pool.make_key(key.split,
                                        owns_weights=key.owns_weights)
            if key.owns_weights and key != pool.active_key \
                    and key != pool.standby_key and stale \
                    and pool.pending(key) is None:
                try:
                    pool.release(key)
                except ValueError:    # became active/in-flight meanwhile
                    pass

        def _done(handle):
            if report is not None:
                report.t_background_wall += handle.t_wall
                report.background_cost += handle.t_wall

        for s in want:
            if pool.has(s, self.owns_weights) \
                    or pool.pending(s, self.owns_weights) is not None:
                continue
            # speculation is best-effort: the job re-enforces the memory
            # budget after it lands (enforce_budget=True)
            pool.submit_build(s, owns_weights=self.owns_weights,
                              cold=self.owns_weights, reuse=True,
                              enforce_budget=True, on_done=_done)
