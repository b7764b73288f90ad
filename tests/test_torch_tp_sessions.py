"""A slot pool of decode sessions (``repro_torch.serving.sessions``)
behind a stateful pipeline whose cloud stage lies on
``set_mesh_devices(["cpu"] * tp)``, tp 2 and 4, against the reference's
single-device pool (``repro.serving.sessions.make_session_manager``) on
the same weights and prompts, each step fed the reference's greedy
tokens: reduced qwen2.5-3b (dense), falcon-mamba-7b (ssm), zamba2-7b
(hybrid) and internvl2-76b (vlm) at 4 layers, 3 slots.

* steps across switch_b2 onto and off the mesh, each transition moving
  0 state bytes (the first step on the mesh places the cloud range's
  state, the first step off it brings it back);
* admission into a free slot, preemption, parking and readmission on the
  mesh (the parked state against the reference's);
* a split move on the mesh on each hand-off arm, the transfer arm's
  payload taken by the reference's ``validate_payload``;
* ``snapshot``/``restore`` on the mesh;
* a split move on the mesh with no live session (no hand-off), whose
  next admission's step reads the entries the move left on the mesh;
* a row write that touches only its row of every shard.

Every logit within 1e-4 of the reference's (``test_torch_tp.py``'s
``TOL``).  The reference itself raises on each of these row writes once
its cache lies on a mesh (``tools/probe_reference_slot_mesh_ops.py``);
the port serves them."""
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
from repro.serving.sessions import SessionManager as JSessionManager  # noqa: E402
from repro.serving.sessions import \
    make_session_manager as jax_session_manager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       unit_index_of_split)
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch.mesh import (reset_mesh_devices,  # noqa: E402
                                     set_mesh_devices)
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import make_session_manager  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)       # the reference's own sharded bound
FAMILIES = ("qwen2.5-3b", "falcon-mamba-7b", "zamba2-7b", "internvl2-76b")
LAYERS, SLOTS, MAX_SEQ, SPLIT, MOVED_SPLIT = 4, 3, 32, 1, 3
# leaves whose values the reference's init leaves at ones or zeros
_PERTURBED = ("scale", "bias", "norm", "D", "dt_bias", "conv_b", "bq", "bk",
              "bv")

# the sequence both pools take; the port switches before the events at
# ONTO (onto the mesh), SPLIT_MOVE (to MOVED_SPLIT) and OFF (off the mesh)
SCRIPT = (("admit", 0), ("admit", 1), ("step",), ("step",),   # 0-3
          ("step",), ("step",),                               # 4-5
          ("admit", 2), ("step",), ("step",),                 # 6-8 free
          ("admit", 3), ("step",), ("step",),                 # 9-11 full
          ("step",), ("step",),                               # 12-13
          ("readmit", "s0"), ("step",), ("step",),            # 14-16 full
          ("step",), ("step",))                               # 17-18
ONTO, PREEMPT, SPLIT_MOVE, OFF = 4, 9, 12, 17


@pytest.fixture(autouse=True)
def cpu_mesh():
    set_mesh_devices(["cpu"] * 4)
    try:
        yield
    finally:
        reset_mesh_devices()


def _decode(entry) -> np.ndarray:
    dtype, shape, buf = entry
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


@pytest.fixture(scope="module", params=FAMILIES)
def ref(request):
    """The reference's single-device pool through ``SCRIPT``: after each
    event the live sessions' logits, the ids, the epoch and the token
    fed; the parked state of s0 when preempted and an export of the
    moved layers before the split move."""
    arch = request.param
    jcfg = dataclasses.replace(get_config(arch).reduced(), num_layers=LAYERS)
    tcfg = dataclasses.replace(tget(arch).reduced(), num_layers=LAYERS)
    rng = np.random.default_rng(7)

    def perturb(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") in _PERTURBED:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    # jitted: the eager init dispatches every draw (5 s a family here)
    init = jax.jit(JT.init_model, static_argnums=0)
    npp = jax.tree_util.tree_map_with_path(
        perturb, init(jcfg, jax.random.PRNGKey(0)))
    prng = np.random.default_rng(1)
    prompts = [prng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 12, 5)]
    jm, jsm = jax_session_manager(
        jcfg, jax.tree.map(jax.numpy.asarray, npp), split=SPLIT,
        net=JNet(1000.0), num_slots=SLOTS, max_seq=MAX_SEQ)
    after, tokens = [], []
    out = types.SimpleNamespace(arch=arch, tcfg=tcfg, tparams=from_numpy(npp),
                                prompts=prompts, after=after, tokens=tokens)
    try:
        for i, ev in enumerate(SCRIPT):
            if i == SPLIT_MOVE:
                out.export = jsm.export_layers(SPLIT, MOVED_SPLIT)[0]
            tok = None
            if ev[0] == "admit":
                jsm.admit(prompts[ev[1]], sid=f"s{ev[1]}")
            elif ev[0] == "readmit":
                jsm.readmit(ev[1])
            else:
                tok = np.asarray(jsm.next_token())
                jm.active.process({"token": tok})
            tokens.append(tok)
            if i == PREEMPT:
                out.parked = {k: _decode(v) for k, v in
                              jsm._parked["s0"]["state"].items()}
            after.append({"logits": {s: np.asarray(jsm.logits_for(s))
                                     for s in jsm.session_ids()},
                          "ids": jsm.session_ids(),
                          "parked": jsm.parked_ids(), "epoch": jsm.epoch})
    finally:
        jm.close()
    return out


def _pool(ref):
    return make_session_manager(ref.tcfg, ref.tparams, split=SPLIT,
                                num_slots=SLOTS, max_seq=MAX_SEQ,
                                net=NetworkModel(1000.0), device="cpu")


def _switch(mgr, split, mesh, arm=None):
    """switch_b2 to ``split`` on ``mesh``; the reshard's moved bytes
    (None where the mesh did not change)."""
    mgr.pool.force_mode = arm
    n = len(mgr.pool.reshards)
    mgr.set_mesh_shape(mesh)
    rep = mgr.repartition("switch_b2", split)
    moved = [r.moved_bytes for r in mgr.pool.reshards[n:]]
    return rep, (moved[0] if moved else None)


def _sharded(sm):
    return sorted(k for k, v in sm.cache.items()
                  if isinstance(v, TP.ShardedTensor))


def _cloud_keys(sm, split):
    u0 = unit_index_of_split(sm.cfg, split)
    return sorted(sm.subset(u0, len(sm.runner.units)))


def _replay(ref, mgr, sm, lo, hi, switches=None):
    """Events [lo, hi) of ``SCRIPT`` on the port's pool, each held to the
    reference's record; ``switches[i]()`` runs before event ``i``."""
    for i in range(lo, hi):
        if switches and i in switches:
            switches[i]()
        ev = SCRIPT[i]
        if ev[0] == "admit":
            assert sm.admit(ref.prompts[ev[1]], sid=f"s{ev[1]}") == \
                f"s{ev[1]}"
        elif ev[0] == "readmit":
            sm.readmit(ev[1])
        else:
            mgr.serve({"token": torch.tensor(ref.tokens[i])})
        want = ref.after[i]
        assert (sm.session_ids(), sm.parked_ids(), sm.epoch) == \
            (want["ids"], want["parked"], want["epoch"]), i
        for sid, lg in want["logits"].items():
            np.testing.assert_allclose(sm.logits_for(sid).numpy(), lg,
                                       err_msg=f"event {i} {sid}", **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_steps_across_mesh_transitions(ref, tp):
    """switch_b2 onto the mesh and off it moves no state (the reference's
    0 bytes); the first step on the mesh places exactly the cloud range's
    entries; an admission right after the switch off writes into the
    entries left there, and the first step off the mesh brings them
    back."""
    mgr, sm = _pool(ref)
    moved = {}

    def onto():
        rep, moved["onto"] = _switch(mgr, SPLIT, (tp,))
        assert rep.mesh_change and _sharded(sm) == []

    def first_mesh_step():
        assert _sharded(sm) == _cloud_keys(sm, SPLIT)

    def off():
        rep, moved["off"] = _switch(mgr, SPLIT, None)
        assert rep.mesh_change and _sharded(sm) == _cloud_keys(sm, SPLIT)
    try:
        _replay(ref, mgr, sm, 0, ONTO + 1, {ONTO: onto})
        first_mesh_step()
        _replay(ref, mgr, sm, ONTO + 1, ONTO + 2)
        # off the mesh, then an admission into the state left there
        _replay(ref, mgr, sm, ONTO + 2, ONTO + 3, {ONTO + 2: off})
        assert _sharded(sm) == _cloud_keys(sm, SPLIT)
        _replay(ref, mgr, sm, ONTO + 3, ONTO + 4)
        assert _sharded(sm) == []
        _replay(ref, mgr, sm, ONTO + 4, PREEMPT)
        assert moved == {"onto": 0, "off": 0}
    finally:
        mgr.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_admission_into_a_free_slot_on_the_mesh(ref, tp):
    """An admission on the mesh writes its row into the placed entries'
    shards (they stay placed) while the live slots keep decoding."""
    mgr, sm = _pool(ref)
    try:
        _replay(ref, mgr, sm, 0, ONTO + 2,
                {ONTO: lambda: _switch(mgr, SPLIT, (tp,))})
        placed = {k: sm.cache[k] for k in _sharded(sm)}
        _replay(ref, mgr, sm, ONTO + 2, ONTO + 3)          # the admission
        assert all(sm.cache[k] is v for k, v in placed.items())
        _replay(ref, mgr, sm, ONTO + 3, PREEMPT)
    finally:
        mgr.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_preemption_parking_and_readmission_on_the_mesh(ref, tp):
    """An admission into the full pool parks the LRU session off the mesh
    (its gathered state equals the reference's parked state); the
    readmission into the full pool parks another and restores it."""
    mgr, sm = _pool(ref)
    try:
        _replay(ref, mgr, sm, 0, PREEMPT + 1,
                {ONTO: lambda: _switch(mgr, SPLIT, (tp,))})
        got = {k: _decode(v) for k, v in sm._parked["s0"]["state"].items()}
        assert got.keys() == ref.parked.keys()
        for k, want in ref.parked.items():
            assert got[k].dtype == want.dtype, k
            np.testing.assert_allclose(got[k], want, err_msg=k, **TOL)
        _replay(ref, mgr, sm, PREEMPT + 1, OFF)
        assert _sharded(sm) == _cloud_keys(sm, SPLIT)
    finally:
        mgr.close()


@pytest.mark.parametrize("arm", ["transfer", "recompute"])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_move_on_the_mesh(ref, tp, arm):
    """switch_b2 to split 3 on the mesh on each hand-off arm: the moved
    layers leave the mesh, the transfer arm's export is the reference's
    (its ``validate_payload`` takes it at the reference's epoch), and the
    pool serves on to the switch off the mesh."""
    mgr, sm = _pool(ref)

    def move():
        if arm == "transfer":
            payload, _ = sm.export_layers(SPLIT, MOVED_SPLIT)
            JSessionManager.validate_payload(
                types.SimpleNamespace(epoch=ref.after[SPLIT_MOVE - 1]
                                      ["epoch"]), payload)
            assert payload.keys() == ref.export.keys()
            for k, v in ref.export.items():
                if k != HANDOFF_META_KEY:
                    np.testing.assert_allclose(
                        _decode(payload[k]), _decode(v), err_msg=k, **TOL)
        rep, moved = _switch(mgr, MOVED_SPLIT, (tp,), arm)
        assert (rep.handoff_mode, moved) == (arm, None)
        assert _sharded(sm) == [k for k in _cloud_keys(sm, SPLIT)
                                if k in _cloud_keys(sm, MOVED_SPLIT)]
    try:
        _replay(ref, mgr, sm, 0, len(SCRIPT), {
            ONTO: lambda: _switch(mgr, SPLIT, (tp,)), SPLIT_MOVE: move,
            OFF: lambda: _switch(mgr, MOVED_SPLIT, None)})
        assert _sharded(sm) == []
    finally:
        mgr.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_snapshot_and_restore_on_the_mesh(ref, tp):
    """A snapshot on the mesh, an admission that preempts and two steps,
    then ``restore``: the entries come back placed, and the same events
    again match the reference."""
    mgr, sm = _pool(ref)
    try:
        _replay(ref, mgr, sm, 0, PREEMPT,
                {ONTO: lambda: _switch(mgr, SPLIT, (tp,))})
        snap = sm.snapshot()
        _replay(ref, mgr, sm, PREEMPT, PREEMPT + 3)
        first = {s: sm.logits_for(s) for s in sm.session_ids()}
        sm.restore(snap)
        assert _sharded(sm) == _cloud_keys(sm, SPLIT)
        assert "s0" in sm.session_ids() and sm.parked_ids() == []
        _replay(ref, mgr, sm, PREEMPT, PREEMPT + 3)
        for s, lg in first.items():
            assert torch.equal(sm.logits_for(s), lg), s
    finally:
        mgr.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_split_move_of_an_empty_pool_on_the_mesh(ref, tp):
    """Every session parked on the mesh, switch_b2 to another split there
    (no live session: no hand-off), an admission: its first step serves
    the layers that left the mesh from the entries the move left placed
    (gathered on the edge), and its logits equal a fresh pool's."""
    mgr, sm = _pool(ref)
    fresh, fsm = _pool(ref)
    try:
        _replay(ref, mgr, sm, 0, ONTO + 1,
                {ONTO: lambda: _switch(mgr, SPLIT, (tp,))})
        for sid in sm.session_ids():
            sm.evict(sid)
        rep, _ = _switch(mgr, MOVED_SPLIT, (tp,))
        assert rep.handoff_mode == "none"
        assert _sharded(sm) == _cloud_keys(sm, SPLIT)
        assert sm.admit(ref.prompts[2], sid="new") == \
            fsm.admit(ref.prompts[2], sid="new")
        tok = fsm.next_token()
        fresh.serve({"token": tok})
        mgr.serve({"token": tok})
        np.testing.assert_allclose(sm.logits_for("new").numpy(),
                                   fsm.logits_for("new").numpy(), **TOL)
        assert _sharded(sm) == _cloud_keys(sm, MOVED_SPLIT)
    finally:
        mgr.close()
        fresh.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_row_write_touches_only_its_row(ref, tp):
    """``ShardedTensor.write_row``/``zero_row``/``read_row`` on every
    placed entry of the family: the row lands in each shard's slice as the
    entry's spec cuts it, every other row of every shard is untouched,
    and a spec that cuts the slot axis is refused."""
    mgr, sm = _pool(ref)
    try:
        _replay(ref, mgr, sm, 0, ONTO + 1,
                {ONTO: lambda: _switch(mgr, SPLIT, (tp,))})
        gen = torch.Generator().manual_seed(0)
        for k in _sharded(sm):
            t = sm.cache[k]
            before = [s.clone() for s in t.shards]
            whole = t.gather("cpu")
            row = torch.randn(tuple(t.shape[1:]), generator=gen).to(t.dtype)
            t.write_row(1, row)
            assert torch.equal(t.read_row(1, "cpu"), row), k
            want = whole.clone()
            want[1] = row
            assert torch.equal(t.gather("cpu"), want), k
            for s, (old, new) in enumerate(zip(before, t.shards)):
                keep = [j for j in range(SLOTS) if j != 1]
                assert torch.equal(old[keep], new[keep]), (k, s)
            t.zero_row(1)
            assert not t.read_row(1, "cpu").any(), k
            for old, new in zip(before, t.shards):
                assert torch.equal(old[[0, 2]], new[[0, 2]]), k
        bad = TP.ShardedTensor([torch.zeros(1, 4)] * 2, P("model"),
                               t.row, (2, 4), torch.float32, None)
        with pytest.raises(AssertionError, match="axis 0"):
            bad.write_row(0, torch.zeros(4))
    finally:
        mgr.close()
