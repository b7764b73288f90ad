"""The port's slot-indexed multi-session pools
(``repro_torch.serving.sessions``) against the JAX package's on the same
weights, for qwen2.5-3b and falcon-mamba-7b (reduced):

* ragged prompts admitted into both packages' slot pools decode to the
  same per-slot logits (5e-4) and the same tokens;
* within the port, bit for bit: a mid-flight admission never perturbs a
  live slot; evict + readmit round-trips; a size-1 position vector equals
  a scalar position; a whole-batch transfer hand-off changes nothing;
* the batch recompute hand-off rebuilds every slot within tolerance;
* a 1-slot pool tracks a ``DecodeSession`` within 5e-4 (not bit for bit:
  its admission is a masked ``(1, max_seq)`` prefill, the session's an
  ``(1, L)`` one, whose products round differently).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.sessions import \
    make_session_manager as jax_session_manager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.state_handoff import per_layer_state_bytes  # noqa: E402
from repro_torch.core.stateful import (StatefulStageRunner,  # noqa: E402
                                       make_stateful_manager)
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import (ServingEngine, SlotPoolFull,  # noqa: E402
                                 VirtualClock, make_session_manager,
                                 request_stream)
from repro_torch.serving.sessions import SessionManager  # noqa: E402

ARCHS = ["qwen2.5-3b", "falcon-mamba-7b"]
MAX_SEQ = 32
ATOL = 5e-4                     # tests/test_decode_hotpath.py:105


def _cfgs(arch, num_layers=2):
    return (dataclasses.replace(get_config(arch).reduced(),
                                num_layers=num_layers),
            dataclasses.replace(tget(arch).reduced(), num_layers=num_layers))


def _ragged(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    cfg, tcfg = _cfgs(request.param)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, params, from_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runner(weights):
    _, tcfg, _, tparams = weights
    return StatefulStageRunner(tcfg, tparams, max_seq=MAX_SEQ, device="cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_slot_pool_matches_jax(weights):
    """Ragged admissions (one mid-flight) and decode steps through both
    packages' edge-cloud slot pools, each step fed the JAX pool's greedy
    tokens; the pool switches split once (transfer arm) on the way."""
    cfg, tcfg, params, tparams = weights
    kw = dict(split=1, num_slots=4, max_seq=MAX_SEQ, force_mode="transfer")
    jm, jsm = jax_session_manager(cfg, params, net=JNet(1000.0), **kw)
    tm, tsm = make_session_manager(tcfg, tparams, net=NetworkModel(1000.0),
                                   device="cpu", **kw)
    prompts = _ragged(cfg.vocab_size, (7, 3, 12, 5), seed=1)

    def check():
        for sid in jsm.session_ids():
            np.testing.assert_allclose(_np(tsm.logits_for(sid)),
                                       jsm.logits_for(sid), atol=ATOL,
                                       err_msg=sid)
            np.testing.assert_array_equal(_np(tsm.tokens_for(sid)),
                                          jsm.tokens_for(sid), err_msg=sid)
        assert tsm.session_ids() == jsm.session_ids()
        np.testing.assert_array_equal(_np(tsm.step_pos()),
                                      np.asarray(jsm.step_pos()))

    def step():
        tok = np.asarray(jsm.next_token())
        jm.active.process({"token": tok})
        tm.active.process({"token": tok})

    for i, p in enumerate(prompts[:3]):
        assert tsm.admit(p, sid=f"s{i}") == jsm.admit(p, sid=f"s{i}")
    check()
    for _ in range(2):
        step()
    check()
    jsm.admit(prompts[3], sid="late")
    tsm.admit(prompts[3], sid="late")
    step()
    check()
    jr, tr = jm.repartition("switch_b2", 2), tm.repartition("switch_b2", 2)
    assert (tr.handoff_mode, tr.handoff_bytes) == \
        (jr.handoff_mode, jr.handoff_bytes) == ("transfer", tr.handoff_bytes)
    for _ in range(2):
        step()
    check()
    jm.close()
    tm.close()


def test_admit_fn_matches_jax_with_per_row_lengths(weights):
    """The masked admission at a (B, max_seq) bucket with a per-row length
    vector (a dead row at 0) against the JAX package's."""
    from repro.core.stateful import StatefulStageRunner as JRunner
    cfg, tcfg, params, tparams = weights
    jr = JRunner(cfg, params, max_seq=MAX_SEQ)
    tr = StatefulStageRunner(tcfg, tparams, max_seq=MAX_SEQ, device="cpu")
    toks = np.zeros((3, MAX_SEQ), np.int32)
    lengths = np.array([9, 0, MAX_SEQ], np.int32)
    for row, n in enumerate(lengths):
        toks[row, :n] = _ragged(cfg.vocab_size, (n,), seed=row)[0]
    jl, jc, jb = jr.admit_fn()(params, jax.numpy.asarray(toks),
                               jax.numpy.asarray(lengths))
    tl, tc, tb = tr.admit_fn()(tr.params, torch.from_numpy(toks).long(),
                               torch.from_numpy(lengths))
    live = [0, 2]
    np.testing.assert_allclose(tl[live].numpy(), np.asarray(jl)[live],
                               atol=ATOL)
    # a dead row's logits are garbage every caller masks; the port takes
    # them at position 0, as a 1-token row does.  (The reference takes
    # them at max_seq - 1: its dynamic_slice wraps the start index -1.)
    one, _, _ = tr.admit_fn()(tr.params, torch.from_numpy(toks[1:2]).long(),
                              1)
    np.testing.assert_allclose(tl[1].numpy(), one[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL)
    assert set(tc) == set(jc)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=ATOL, err_msg=k)
    # the dead row's boundary checkpoints and KV are masked to zeros
    assert not tb[:, 1].any()
    for k in tc:
        if k[0] in "kv":
            assert not tc[k][1].any(), k


def test_midflight_admission_never_perturbs_live_slots(runner):
    pa, pb = _ragged(runner.cfg.vocab_size, (5, 9))
    solo = SessionManager(runner, num_slots=4)
    a = solo.admit(pa)
    for _ in range(2):
        solo.decode_step()
    solo_mid = solo.logits_for(a)
    for _ in range(2):
        solo.decode_step()
    solo_final, solo_toks = solo.logits_for(a), solo.tokens_for(a)

    sm = SessionManager(runner, num_slots=4)
    a2 = sm.admit(pa)
    for _ in range(2):
        sm.decode_step()
    assert torch.equal(sm.logits_for(a2), solo_mid)
    b = sm.admit(pb)                 # mid-flight, into a masked dead slot
    for _ in range(2):
        sm.decode_step()
    assert torch.equal(sm.logits_for(a2), solo_final)
    assert torch.equal(sm.tokens_for(a2), solo_toks)
    assert sm.slot_info(b).pos == len(pb) + 2


def test_evict_readmit_round_trips_state(runner):
    pa, pb, pc = _ragged(runner.cfg.vocab_size, (6, 4, 3), seed=1)
    sm = SessionManager(runner, num_slots=3)
    a, b = sm.admit(pa), sm.admit(pb)
    sm.decode_step()
    snap_a = {k: v[0].clone() for k, v in sm.cache.items()}
    before_logits, before_toks = sm.logits_for(a), sm.tokens_for(a)
    sm.evict(a)
    assert a in sm.parked_ids() and sm.session_ids() == [b]
    assert all(not v[0].any() for v in sm.cache.values())   # slot zeroed
    sm.admit(pc)                     # pool keeps serving while a is parked
    sm.decode_step()
    sm.readmit(a)
    j = next(s.index for s in sm._slots if s.sid == a)
    for k, v in snap_a.items():
        got = sm.cache[k][j]
        if k[0] in "kv":             # KV rows beyond the prefix are zero
            pos = before_toks.shape[0]
            assert torch.equal(got[:, :pos], v[:, :pos]), k
        else:
            assert torch.equal(got, v), k
    assert torch.equal(sm.logits_for(a), before_logits)
    assert torch.equal(sm.tokens_for(a), before_toks)
    sm.decode_step()                 # restored state still decodes
    assert sm.slot_info(a).pos == before_toks.shape[0] + 1


def test_size_one_pos_vector_equals_scalar_pos(runner):
    """One decode step over every unit with the position as a 0-d tensor
    and as a size-1 vector: bit-equal output, state and checkpoints."""
    U = len(runner.units)
    fn = runner._make_decode_fn(0, U)
    sm = SessionManager(runner, num_slots=1)
    sm.admit(_ragged(runner.cfg.vocab_size, (6,), seed=2)[0])
    x = runner.params["embed"][sm.next_token()]
    outs = []
    for pos in (torch.tensor(6, dtype=torch.int32),
                torch.tensor([6], dtype=torch.int32)):
        cache = {k: v.clone() for k, v in sm.subset(0, U).items()}
        outs.append(fn(runner.params, x, cache, pos))
    (xa, na, ba), (xb, nb, bb) = outs
    assert torch.equal(xa, xb) and torch.equal(ba, bb)
    assert set(na) == set(nb)
    for k in na:
        assert torch.equal(na[k], nb[k]), k


def _eight_session_pool(tcfg, tparams, force_mode):
    nl = tcfg.num_layers
    mgr, sm = make_session_manager(tcfg, tparams, split=nl,
                                   net=NetworkModel(1000.0), num_slots=8,
                                   max_seq=MAX_SEQ, force_mode=force_mode,
                                   device="cpu")
    sids = [sm.admit(p) for p in _ragged(tcfg.vocab_size, range(3, 11),
                                         seed=7)]
    for _ in range(2):
        mgr.active.process()
    snap = sm.snapshot()
    for _ in range(2):               # control arm: no switch
        mgr.active.process()
    control = {s: (sm.logits_for(s), sm.tokens_for(s)) for s in sids}
    sm.restore(snap)
    return mgr, sm, sids, snap, control


def test_batch_transfer_bit_identical_eight_ragged_sessions(weights):
    """Transfer arm: 8 ragged sessions survive a repartition away and
    back with zero drops and per-slot bit-identical logits and tokens
    against a no-switch control."""
    _, tcfg, _, tparams = weights
    nl = tcfg.num_layers
    mgr, sm, sids, snap, control = _eight_session_pool(tcfg, tparams,
                                                       "transfer")
    mgr.repartition("switch_b2", 1)          # moves layers [1, nl)
    assert mgr.pool.handoffs[-1].mode == "transfer"
    for k, v in snap["cache"].items():       # the hand-off itself is exact
        if k[0] in "kv":                     # KV beyond the live prefix
            pos = sm.pos                     # is not carried
            assert torch.equal(sm.cache[k][:, :, :pos], v[:, :, :pos]), k
        else:
            assert torch.equal(sm.cache[k], v), k
    mgr.repartition("switch_b2", nl)         # and back
    assert mgr.pool.handoffs[-1].mode == "transfer"
    assert not any(h.fallback for h in mgr.pool.handoffs)
    for _ in range(2):
        mgr.active.process()
    assert set(sm.session_ids()) == set(sids)    # zero dropped
    for s in sids:
        logits, toks = control[s]
        assert torch.equal(sm.logits_for(s), logits), s
        assert torch.equal(sm.tokens_for(s), toks), s
    mgr.close()


def test_batch_recompute_preserves_eight_ragged_sessions(weights):
    """Recompute arm: the masked fixed-shape rebuild with a per-slot
    length vector restores every slot within tolerance, the greedy
    trajectories survive the switch, nothing is dropped."""
    _, tcfg, _, tparams = weights
    mgr, sm, sids, snap, control = _eight_session_pool(tcfg, tparams,
                                                       "recompute")
    tok_before = sm.next_token().clone()
    mgr.repartition("switch_b2", 1)
    h = mgr.pool.handoffs[-1]
    assert h.mode == "recompute" and not h.fallback
    for k, v in snap["cache"].items():
        np.testing.assert_allclose(sm.cache[k].numpy(), v.numpy(),
                                   atol=1e-4, err_msg=k)
    assert torch.equal(sm.next_token(), tok_before)
    for _ in range(2):
        mgr.active.process()
    assert set(sm.session_ids()) == set(sids)
    for s in sids:
        logits, toks = control[s]
        assert torch.equal(sm.tokens_for(s), toks), s
        np.testing.assert_allclose(sm.logits_for(s).numpy(), logits.numpy(),
                                   atol=1e-4, err_msg=s)
    mgr.close()


def test_slot_count_one_tracks_decode_session():
    """The port's twin of the reference's slot-count-one test, held to
    5e-4 (see the module docstring for why not bit for bit)."""
    _, tcfg = _cfgs("qwen2.5-3b")
    net = NetworkModel(1000.0)
    mgr1, session = make_stateful_manager(tcfg, split=1, net=net,
                                          prompt_len=8, max_seq=MAX_SEQ,
                                          seed=0, device="cpu")
    for _ in range(3):
        mgr1.active.process()
    mgrp, sm = make_session_manager(tcfg, mgr1.runner.params, split=1,
                                    net=net, num_slots=1, max_seq=MAX_SEQ,
                                    device="cpu")
    sid = sm.admit(session.tokens[0, :8])
    for _ in range(3):
        mgrp.active.process()
    np.testing.assert_allclose(sm.logits_for(sid).numpy(),
                               session.last_logits[0].numpy(), atol=ATOL)
    assert torch.equal(sm.tokens_for(sid), session.tokens[0])
    mgr1.close()
    mgrp.close()


def test_preemption_parks_lru_and_full_pool_raises(runner):
    pa, pb, pc = _ragged(runner.cfg.vocab_size, (4, 5, 6), seed=3)
    strict = SessionManager(runner, num_slots=2, allow_preempt=False)
    strict.admit(pa), strict.admit(pb)
    with pytest.raises(SlotPoolFull):
        strict.admit(pc)
    sm = SessionManager(runner, num_slots=2)
    a, b = sm.admit(pa), sm.admit(pb)
    c = sm.admit(pc)                 # preempts the LRU live slot (a)
    assert sm.parked_ids() == [a]
    assert set(sm.session_ids()) == {b, c}


def test_memory_budget_evicts_lru_on_admission(runner):
    cfg = runner.cfg
    per = per_layer_state_bytes(cfg, seq_len=8, batch=1, act_bytes=4) \
        * len(runner.units)
    sm = SessionManager(runner, num_slots=4, mem_budget_bytes=int(2.5 * per))
    pa, pb, pc = _ragged(cfg.vocab_size, (8, 8, 8), seed=4)
    a, b = sm.admit(pa), sm.admit(pb)
    assert sm.state_bytes() <= 2.5 * per
    c = sm.admit(pc)                 # third live slot busts the budget
    assert a in sm.parked_ids()
    assert set(sm.session_ids()) == {b, c}
    assert sm.state_bytes() <= 2.5 * per


def test_moe_family_and_empty_pool_rejected():
    _, tcfg = _cfgs("qwen2.5-3b")
    fake = types.SimpleNamespace(cfg=dataclasses.replace(tcfg, family="moe"))
    with pytest.raises(ValueError, match="MoE"):
        SessionManager(fake, num_slots=2)
    # a real MoE runner (the stateful path serves the family) is refused
    # all the same: capacity routing couples the slots' rows
    moe = tget("qwen2-moe-a2.7b").reduced()
    with pytest.raises(ValueError, match="MoE"):
        SessionManager(StatefulStageRunner(moe, init_model(moe, device="cpu"),
                                           device="cpu"), num_slots=2)
    fake.cfg = tcfg
    with pytest.raises(ValueError, match="num_slots"):
        SessionManager(fake, num_slots=0)


def test_engine_scheduled_admission_and_session_attribution():
    _, tcfg = _cfgs("qwen2.5-3b")
    mgr, sm = make_session_manager(tcfg, split=1, net=NetworkModel(1000.0),
                                   num_slots=2, max_seq=MAX_SEQ, seed=0,
                                   device="cpu")
    first, mid = _ragged(tcfg.vocab_size, (6, 4), seed=9)
    sm.admit(first, sid="first")
    eng = ServingEngine(mgr, clock=VirtualClock())
    eng.schedule_admit(1.0, mid, sid="mid")
    tl = eng.run(request_stream({}, fps=2.0, duration=2.0))
    assert set(sm.session_ids()) == {"first", "mid"}
    assert tl.session_summary()["first"]["served"] >= 1
    early = [r for r in tl.records if r.served and r.t_arrival < 1.0]
    assert early and all(r.sessions == ("first",) for r in early)
    late = [r for r in tl.records if r.served and r.t_arrival >= 1.0]
    assert late and all(set(r.sessions) == {"first", "mid"} for r in late)
    mgr.close()


def test_concurrent_admit_evict_readmit_keep_the_slot_table(runner):
    """More threads than cores admit, evict and readmit sessions of one
    pool with a shortened switch interval: every session ends exactly
    once either live or parked, live slots hold distinct sessions, and
    each slot's device position equals its host record."""
    import sys
    import threading

    sm = SessionManager(runner, num_slots=3)
    prompts = _ragged(runner.cfg.vocab_size, [3 + i % 5 for i in range(12)],
                      seed=5)
    errors, sids = [], []
    lock = threading.Lock()

    def worker(w):
        try:
            for i in range(w, len(prompts), 12):
                sid = sm.admit(prompts[i], sid=f"w{i}")
                with lock:
                    sids.append(sid)
                if i % 3 == 0:
                    try:
                        sm.evict(sid)
                        sm.readmit(sid)
                    except KeyError:       # preempted by another admit
                        pass
        except Exception as e:             # surfaced by the assert below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    live, parked = sm.session_ids(), sm.parked_ids()
    assert len(live) == len(set(live)) == 3
    assert sorted(live + parked) == sorted(sids)
    pos = sm.step_pos().tolist()
    for sid in live:
        info = sm.slot_info(sid)
        assert pos[info.index] == info.pos == sm.tokens_for(sid).shape[0]


# -- state keeps its address: what a CUDA graph of a stage binds -----------

@pytest.mark.parametrize("writer", ["step", "import", "recompute"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_pool_state_writers_keep_each_entrys_address(arch, writer):
    """A step's commit, ``import_layers`` and ``recompute_layers`` write
    into a slot pool's state buffers where they lie (reduced ssm and
    hybrid models, 4 layers, 3 slots, two sessions admitted): every entry
    keeps its ``data_ptr`` (a CUDA graph of a stage binds it) and holds
    what binding the writer's new tensors in its place gave (the eager
    stages' new state, the exported pool, the re-prefill's caches)."""
    from repro_torch.core.stateful import unit_index_of_split
    tcfg = dataclasses.replace(tget(arch).reduced(), num_layers=4)
    mgr, sm = make_session_manager(tcfg, split=2, net=NetworkModel(20.0),
                                   num_slots=3, max_seq=MAX_SEQ,
                                   device="cpu")
    for i, p in enumerate(_ragged(tcfg.vocab_size, (7, 12), seed=5)):
        sm.admit(p, sid=f"s{i}")
    mgr.active.process()
    r, pipe = sm.runner, mgr.active
    ptrs = {k: v.data_ptr() for k, v in sm.cache.items()}
    want = {k: v.clone() for k, v in sm.cache.items()}
    if writer == "step":
        token, pos = sm.next_token(), sm.step_pos()
        ue, ua = pipe._u_edge, pipe._u_all
        _, new, _, _ = pipe._step(
            token, {k: want[k] for k in sm.subset(0, ue)},
            {k: want[k] for k in sm.subset(ue, ua)}, pos)
        want.update(new)
        pipe.process({"token": token})
    elif writer == "import":
        payload, _ = sm.export_layers(0, 4)
        for v in sm.cache.values():
            v.fill_(7)
        sm.import_layers(payload)
    else:
        u0, u1 = unit_index_of_split(tcfg, 1), unit_index_of_split(tcfg, 3)
        want.update(r.recompute_fn(u0, u1)(r.params, sm._bounds[u0].clone(),
                                            sm.step_pos()))
        sm.recompute_layers(1, 3)
    assert {k: v.data_ptr() for k, v in sm.cache.items()} == ptrs
    for k, v in sm.cache.items():
        assert torch.equal(v, want[k]), k
    mgr.close()


class _RerunGraph:
    """A stand-in for a stage's CUDA graph on the CPU: ``capture`` keeps
    the stage function and static inputs without running them (a capture
    runs nothing), ``replay`` copies the inputs in and runs the stage over
    the static buffers, as a replay of the captured launches would."""

    def __init__(self):
        self.refused, self.run, self.captures = None, None, 0

    def matches(self, bound, inputs):
        return self.run is not None and bound == self.bound \
            and inputs.keys() == self.inputs.keys()

    def capture(self, run, bound, inputs):
        from repro_torch.core.stages import abstractify, materialize
        self.run, self.bound = run, dict(bound)
        self.inputs = materialize(abstractify(inputs))
        self.captures += 1
        return True

    def replay(self, inputs):
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        return tuple(self.run(self.inputs))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_graph_route_with_a_stand_in_graph_equals_the_eager_route(
        arch, monkeypatch):
    """The pipeline's graph route on the CPU, each stage a stand-in that
    replays the captured in-place stage over its static inputs, against
    the eager route on the same weights, bit for bit, through an
    eviction, an admission, a switch on each hand-off arm and an entry
    rebound by hand (recaptured): what the CUDA graphs replay on the card
    is the stage written for the capture."""
    from repro_torch.core import stateful as SF
    monkeypatch.setattr(SF, "addresses", lambda st: {
        k: v.data_ptr() for k, v in st.items()})
    tcfg = dataclasses.replace(tget(arch).reduced(), num_layers=4)
    params = init_model(tcfg, device="cpu", seed=1)
    kw = dict(split=2, net=NetworkModel(1000.0), num_slots=3, max_seq=MAX_SEQ,
              device="cpu")
    (gm, g), (em, e) = [make_session_manager(tcfg, params, **kw)
                        for _ in range(2)]
    prompts = _ragged(tcfg.vocab_size, (5, 9, 13), seed=2)
    for s in (g, e):
        for i, p in enumerate(prompts[:2]):
            s.admit(p, sid=f"s{i}")
    stand_ins = []
    for i in range(16):
        if i == 4:
            for s in (g, e):
                s.evict("s0")
                s.admit(prompts[2], sid="s2")
        if i in (7, 11):
            split, arm = (1, "recompute") if i == 7 else (3, "transfer")
            for m in (gm, em):
                m.pool.force_mode = arm
                assert m.repartition("switch_b2", split).handoff_mode == arm
        if i == 13:
            k = sorted(g.cache)[-1]
            g.cache[k] = g.cache[k].clone()
        if gm.active.graphs is None:
            gm.active.graphs = (_RerunGraph(), _RerunGraph())
            stand_ins.extend(gm.active.graphs)
        tok = e.next_token()
        a, _ = gm.active.process({"token": tok})
        b, _ = em.active.process({"token": tok})
        assert torch.equal(a, b) and torch.equal(g.last_logits,
                                                 e.last_logits), i
    for k, v in g.cache.items():
        assert torch.equal(v, e.cache[k]), k
    assert sum(x.captures for x in stand_ins) == 2 * 3 + 1
    gm.close()
    em.close()
