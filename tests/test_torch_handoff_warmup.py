"""Where a recompute hand-off draws its memory, and what phase 4 of
``chip_smoke.py`` holds around switch_a.  ``build_standby`` runs, once on
scratch input, the re-prefill that switching to the standby will run,
in the session's ``RecomputeArena`` (a private pool of the caching
allocator on the card), and leaves the stream's state as it was; the
next hand-off over the same layers draws from the arena, any other runs
in the shared cache (``core/stateful.py``).  On the CPU the arena has no
pool, so these tests put a recording arena in its seat.
``chip_smoke.builds_held`` holds the pool's build worker across a block,
so the standby that switch_a re-arms (a weight copy of its own) starts
building after the switch and phase 4's allocator counters read the
switch's own allocations."""
import contextlib
import dataclasses
import os
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.stateful import (RecomputeArena,  # noqa: E402
                                       make_stateful_manager)
from repro_torch.serving.sessions import make_session_manager  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402

PROMPT, MAX_SEQ = 8, 32


class RecordingArena(RecomputeArena):
    """The arena on the CPU, with its pool replaced by a flag that says
    whether a re-prefill runs inside it."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.inside = False

    @contextlib.contextmanager
    def _pool(self):
        assert not self.inside
        self.inside = True
        try:
            yield
        finally:
            self.inside = False


def _cfg():
    return dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                               num_layers=4)


def _spy(runner, arena, log):
    """Log the unit range of every re-prefill the runner runs (the
    warm-up's and the hand-offs') and whether it ran in the arena."""
    real = runner.recompute_fn

    def spy(u0, u1):
        fn = real(u0, u1)

        def run(*args):
            log.append(((u0, u1), arena.inside))
            return fn(*args)
        return run
    runner.recompute_fn = spy


def _state(snap):
    return [snap["pos"], snap["tokens"], snap["bounds"],
            *(snap["cache"][k] for k in sorted(snap["cache"]))]


def _same(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def test_cpu_arena_has_no_pool():
    arena = RecomputeArena(torch.device("cpu"))
    assert arena.pool is None
    runs = []
    arena.warm((1, 3), lambda: runs.append(1))
    assert runs == [1] and arena.warmed == (1, 3)
    with arena.use((1, 3)):
        pass
    assert arena.warmed is None                 # one hand-off a warm-up


def test_decode_session_handoff_draws_from_the_warmed_arena():
    mgr, s = make_stateful_manager(_cfg(), split=1, net=NetworkModel(20.0),
                                   prompt_len=PROMPT, max_seq=MAX_SEQ,
                                   force_mode="recompute", device="cpu")
    try:
        mgr.active.process()
        s.arena = arena = RecordingArena()
        log = []
        _spy(s.runner, arena, log)
        rep = mgr.repartition("switch_b2", 2)       # nothing warmed 1 -> 2
        assert rep.handoff_mode == "recompute"
        assert log == [((1, 2), False)]
        before = _state(s.snapshot())
        mgr.build_standby(3)
        assert log[1:] == [((2, 3), True)]          # one warm run, 2 -> 3
        assert _same(_state(s.snapshot()), before)  # state untouched
        rep = mgr.repartition("switch_a", 3)
        assert rep.handoff_mode == "recompute"
        assert log[2:] == [((2, 3), True)]          # the hand-off, in it
        mgr.drain()
        # switch_a re-armed split 2 on the worker, with no warm-up: the
        # next hand-off over the same layers runs in the shared cache
        rep = mgr.repartition("switch_a", 2)
        assert rep.handoff_mode == "recompute"
        assert log[3:] == [((2, 3), False)]
    finally:
        del s.runner.recompute_fn
        mgr.close()


def test_slot_pool_handoff_draws_from_the_warmed_arena():
    cfg = _cfg()
    mgr, sm = make_session_manager(cfg, split=1, net=NetworkModel(20.0),
                                   num_slots=2, max_seq=MAX_SEQ,
                                   force_mode="recompute", device="cpu")
    try:
        gen = torch.Generator().manual_seed(3)
        sm.admit(torch.randint(0, cfg.vocab_size, (1, PROMPT),
                               generator=gen))
        mgr.active.process({"token": torch.zeros((2, 1), dtype=torch.long)})
        cache = {k: v.clone() for k, v in sm.cache.items()}
        sm.arena = arena = RecordingArena()
        log = []
        _spy(sm.runner, arena, log)
        mgr.build_standby(2)
        assert log == [((1, 2), True)]
        assert all(torch.equal(sm.cache[k], v) for k, v in cache.items())
        mgr.repartition("switch_a", 2)
        assert log[1:] == [((1, 2), True)]
        mgr.repartition("switch_b2", 3)
        assert log[2:] == [((2, 3), False)]
    finally:
        del sm.runner.recompute_fn
        mgr.close()


def test_builds_held_starts_the_rearmed_standby_after_the_block():
    mgr, s = make_stateful_manager(_cfg(), split=1, net=NetworkModel(20.0),
                                   prompt_len=PROMPT, max_seq=MAX_SEQ,
                                   force_mode="recompute", device="cpu")
    pool = mgr.pool
    built = []
    real = pool.ensure

    def ensure(key, *args, **kw):
        built.append((threading.current_thread().name, key))
        return real(key, *args, **kw)
    pool.ensure = ensure
    try:
        mgr.active.process()
        mgr.build_standby(3)
        built.clear()
        with CS.builds_held(mgr):
            rep = mgr.repartition("switch_a", 3)
            time.sleep(0.2)          # room for a worker that was not held
            assert rep.strategy == "switch_a" and rep.new_split == 3
            assert built == []       # switch_a re-armed split 1: it waits
        mgr.drain()
        assert len(built) == 1
        thread, key = built[0]
        assert thread != threading.current_thread().name
        assert pool.standby is not None and pool.standby.split == 1
    finally:
        del pool.ensure
        mgr.close()
