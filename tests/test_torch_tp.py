"""The tensor-parallel cloud stage (``repro_torch.distributed.tp``) on
``set_mesh_devices(["cpu"] * tp)`` against the JAX package's
single-device forward on the same weights: reduced qwen2.5-3b and
internvl2-76b (4 query heads over 1 KV head) at tp 2 and 4, where each KV
head is replicated on the shards that read it, and at tp 8, where the
attention degrades to replicated compute with a warning; the stateless
mesh repartition at every split; the stateful round trip onto a 2-way
mesh and back; a transfer hand-off out of a mesh pipeline that the
reference's ``validate_payload`` takes; CNNs refused on a mesh, and a slot
pool served there.  The other families' mesh stages:
``test_torch_tp_families.py``; a slot pool's admissions, parking and
hand-offs on a mesh: ``test_torch_tp_sessions.py``."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.stages import StageRunner as JRunner  # noqa: E402
from repro.core.stateful import make_stateful_manager as jax_manager  # noqa: E402
from repro.core.stateful import payload_checksum as jax_checksum  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pipeline import EdgeCloudPipeline  # noqa: E402
from repro_torch.core.stages import CnnStageRunner, StageRunner  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       StatefulEdgeCloudPipeline,
                                       make_stateful_manager)
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.distributed.sharding import ShardingDegraded  # noqa: E402
from repro_torch.launch.mesh import (reset_mesh_devices,  # noqa: E402
                                     set_mesh_devices)
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import make_session_manager  # noqa: E402

SEQ = 12
TOL = dict(rtol=1e-4, atol=1e-4)       # the reference's own sharded bound


@pytest.fixture(autouse=True)
def cpu_mesh():
    set_mesh_devices(["cpu"] * 8)
    try:
        yield
    finally:
        reset_mesh_devices()


def make_pair(arch, **odd):
    """One set of weights and one request in both packages (the reduced
    config with the fields ``odd`` replaced); the JAX runner's
    single-device logits at every position."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **odd)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (1, SEQ))}
    if cfg.frontend == "vision":
        inputs["vision_embeds"] = rng.normal(
            size=(1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    jr = JRunner(cfg, params)
    want = np.asarray(jr.run_units(inputs, 0, jr.num_units)["logits"])
    tr = StageRunner(dataclasses.replace(tget(arch).reduced(), **odd),
                     from_numpy(jax.tree.map(np.asarray, params)),
                     attn_impl="kernel", device="cpu")
    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    return tr, tin, want


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-76b"])
def test_executor_matches_reference_forward(arch, tp):
    tr, tin, want = make_pair(arch)
    cfg = tr.cfg
    for split in range(tr.num_units - 1):
        pipe = EdgeCloudPipeline(tr, split, NetworkModel(20.0),
                                 mesh_shape=(tp,))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rep = pipe.build(tin, cold=False)
        degraded = [x for x in w if issubclass(x.category, ShardingDegraded)]
        if tp == 8:      # 4 query heads do not split 8 ways
            assert len(degraded) == 1 and "attention" in \
                str(degraded[0].message)
        else:
            assert not degraded
        lay = pipe.cloud_params.layout
        assert (lay.heads is None) == (tp == 8)
        assert lay.ff is not None and lay.vocab is not None
        assert rep.t_reshard > 0.0
        for s, shard in enumerate(pipe.cloud_params.shards):
            wk = shard["layers"]["attn"]["wk"]
            wq = shard["layers"]["attn"]["wq"]
            assert wk.is_contiguous() and wq.is_contiguous()
            # one KV head (replicated) beside the shard's query heads
            assert wk.shape[-1] == cfg.num_kv_heads * cfg.head_dim
            assert wq.shape[-1] == cfg.num_heads * cfg.head_dim // (
                1 if tp == 8 else tp)
        got, _ = pipe.process(tin)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"split {split}")
        assert pipe.live_param_bytes() == 2 * pipe.cloud_params.logical_bytes
        again, _ = pipe.process(tin)
        assert torch.equal(again, got)      # fixed all-reduce order
        pipe.close()
        assert pipe.live_param_bytes() == 0


@pytest.mark.parametrize("tp", [2, 4])
def test_executor_with_kv_heads_in_blocks_matches_reference(tp):
    """8 query heads over 4 KV heads: each shard holds its own block of
    the KV heads, no KV head is replicated."""
    tr, tin, want = make_pair("qwen2.5-3b", num_heads=8, num_kv_heads=4)
    cfg = tr.cfg
    pipe = EdgeCloudPipeline(tr, 1, NetworkModel(20.0), mesh_shape=(tp,))
    try:
        pipe.build(tin, cold=False)
        assert pipe.cloud_params.layout.heads[-1] == (8 - 8 // tp, 8,
                                                      4 - 4 // tp, 4)
        for shard in pipe.cloud_params.shards:
            assert shard["layers"]["attn"]["wk"].shape[-1] == \
                cfg.num_kv_heads * cfg.head_dim // tp
        got, _ = pipe.process(tin)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    finally:
        pipe.close()


def test_stateless_mesh_repartition_every_split():
    """A ``PipelineManager`` moved onto a 2-way mesh, then through every
    split on it under switch_b2 and switch_a, then back: each request's
    logits are the reference's, and a built pipeline moves no weights on
    the stream."""
    tr, tin, want = make_pair("qwen2.5-3b")
    mgr = PipelineManager(tr, split=0, net=NetworkModel(20.0),
                          sample_inputs=tin)
    try:
        first, _ = mgr.serve(tin)
        mgr.set_mesh_shape((2,))
        rep = mgr.repartition("switch_b2", 0)
        assert rep.mesh_change and rep.old_mesh is None \
            and rep.new_mesh == (2,) and rep.t_reshard >= 0.0
        assert mgr.pool.reshards[-1].moved_bytes == 0
        for split in range(tr.num_units - 1):
            if split:
                mgr.build_standby(split)
                rep = mgr.repartition("switch_a", split)
                assert not rep.mesh_change and rep.t_reshard == 0.0
            out, _ = mgr.serve(tin)
            np.testing.assert_allclose(out.numpy(), want, **TOL,
                                       err_msg=f"split {split}")
            assert torch.equal(mgr.serve(tin)[0], out)
        mgr.set_mesh_shape(None)
        rep = mgr.repartition("switch_b2", 0)
        assert rep.mesh_change and rep.old_mesh == (2,) \
            and rep.new_mesh is None
        assert torch.equal(mgr.serve(tin)[0], first)
        assert len(mgr.pool.reshards) == 2
    finally:
        mgr.close()


def _cloud_state_bytes(pipe) -> int:
    sub = pipe.session.subset(pipe._u_edge, pipe._u_all)
    return sum(v.numel() * v.element_size() for v in sub.values())


@pytest.mark.parametrize("arch,tp", [("qwen2.5-3b", 2),
                                     ("internvl2-76b", 4)])
def test_stateful_mesh_roundtrip_decodes_identically(arch, tp):
    """Decode streams with and without a mid-stream hop onto a mesh (and
    back) emit the same tokens; both transitions are on their reports,
    each moving the live cloud-range state."""
    cfg = tget(arch).reduced()
    kw = dict(split=1, net=NetworkModel(50.0), prompt_len=8, max_seq=32,
              seed=3, device="cpu")
    mgr, sess = make_stateful_manager(cfg, **kw)
    try:
        ref = [mgr.serve(None)[0] for _ in range(4)]
        ref_toks = sess.tokens.clone()
    finally:
        mgr.close()
    mgr, sess = make_stateful_manager(cfg, **kw)
    try:
        out = [mgr.serve(None)[0]]
        mgr.set_mesh_shape((tp,))
        r1 = mgr.repartition("switch_b2", 1)
        moved1 = mgr.pool.reshards[-1].moved_bytes
        assert moved1 == _cloud_state_bytes(mgr.active) > 0
        assert all(isinstance(sess.cache[k], TP.ShardedTensor)
                   for k in ("k1", "v1"))
        assert not isinstance(sess.cache["k0"], TP.ShardedTensor)
        out.append(mgr.serve(None)[0])
        mgr.set_mesh_shape(None)
        r2 = mgr.repartition("switch_b2", 1)
        assert mgr.pool.reshards[-1].moved_bytes == moved1
        assert not any(isinstance(v, TP.ShardedTensor)
                       for v in sess.cache.values())
        out += [mgr.serve(None)[0] for _ in range(2)]
        toks = sess.tokens.clone()
    finally:
        mgr.close()
    assert r1.mesh_change and r1.new_mesh == (tp,)
    assert r2.mesh_change and r2.old_mesh == (tp,) and r2.new_mesh is None
    assert torch.equal(toks, ref_toks)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_mesh_transfer_payload_is_the_references():
    """A transfer hand-off out of a mesh pipeline gathers the sharded
    state first: the same keys, shapes, dtypes and CRC32 as the JAX
    session's own export, its ``validate_payload`` takes it, and the
    decode on the mesh agrees with the JAX session's on the same weights
    and tokens."""
    cfg = get_config("qwen2.5-3b").reduced()
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jm, js = jax_manager(cfg, params, split=1, net=JNet(50.0), prompt_len=8,
                         max_seq=32, seed=3)
    tm, ts = make_stateful_manager(
        tget("qwen2.5-3b").reduced(),
        from_numpy(jax.tree.map(np.asarray, params)), split=1,
        net=NetworkModel(50.0), max_seq=32, device="cpu",
        prompt=np.asarray(js.tokens), force_mode="transfer")
    try:
        tm.set_mesh_shape((2,))
        tm.repartition("switch_b2", 1)
        for _ in range(3):
            tok = np.asarray(js.next_token())
            want, _ = jm.serve({"token": tok})
            got, _ = tm.serve({"token": torch.tensor(tok)})
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        L = cfg.num_layers
        assert isinstance(ts.cache[f"k{L - 1}"], TP.ShardedTensor)
        payload, nbytes = ts.export_layers(0, L)
        jpayload, jbytes = js.export_layers(0, L)
        assert nbytes == jbytes
        assert {k: v[:2] for k, v in payload.items()
                if k != HANDOFF_META_KEY} == \
            {k: v[:2] for k, v in jpayload.items()
             if k != HANDOFF_META_KEY}
        assert payload[HANDOFF_META_KEY][2] == jax_checksum(payload)
        js.validate_payload(payload)
        js.import_layers(payload)
        for k, v in ts.cache.items():
            np.testing.assert_array_equal(
                np.asarray(js.cache[k]), TP.whole(v, "cpu").numpy(),
                err_msg=k)
        # a switch on the mesh moving the sharded layer to the edge
        rep = tm.repartition("switch_b2", L)
        assert rep.handoff_mode == "transfer" and not rep.mesh_change
        assert not isinstance(ts.cache[f"k{L - 1}"], TP.ShardedTensor)
        tok = np.asarray(js.next_token())
        want, _ = jm.serve({"token": tok})
        got, _ = tm.serve({"token": torch.tensor(tok)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    finally:
        jm.close()
        tm.close()


def test_mesh_refuses_cnns():
    cnn = CnnStageRunner(tget("mobilenetv2"),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(NotImplementedError):
        EdgeCloudPipeline(cnn, 1, NetworkModel(20.0), mesh_shape=(2,))


def test_mesh_serves_slot_pools():
    """A slot pool's pipeline on a (2,) mesh builds and serves a step
    whose logits equal the single-device pipeline's (1e-4), and places
    the cloud range's entries per shard."""
    mgr, sm = make_session_manager(tget("qwen2.5-3b").reduced(), split=1,
                                   num_slots=2, max_seq=16,
                                   net=NetworkModel(20.0), device="cpu")
    try:
        sm.admit(np.arange(5) % 97)
        snap = sm.snapshot()
        one = mgr.active
        mesh = StatefulEdgeCloudPipeline(mgr.runner, 1, NetworkModel(20.0),
                                         session=sm, mesh_shape=(2,))
        mesh.build(cold=False)
        tok = sm.next_token()
        want, _ = one.process({"token": tok})
        sm.restore(snap)
        got, _ = mesh.process({"token": tok})
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        assert isinstance(sm.cache["k1"], TP.ShardedTensor)
        mesh.close()
    finally:
        mgr.close()
