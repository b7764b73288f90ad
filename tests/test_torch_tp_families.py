"""The tensor-parallel cloud stage (``repro_torch.distributed.tp``) of the
ssm, hybrid, moe and audio families on ``set_mesh_devices(["cpu"] *
tp)`` against the JAX package's single-device forward on the same
weights: reduced falcon-mamba-7b (channel-parallel Mamba-1), zamba2-7b
(head-parallel Mamba-2 with its shared attention block), qwen2-moe-a2.7b
(expert-parallel MoE) and whisper-medium (its decoder's self and cross
attention) at tp 2 and 4; the degraded layouts (Mamba-2 heads that do not
divide, an expert count that does not, taking the in-expert fallback);
an MoE whose capacity drops assignments; the stateless mesh repartition
at every split; the stateful round trip onto a 2-way mesh and back; a
transfer hand-off out of a mesh pipeline holding conv and SSM state that
the reference's ``validate_payload`` takes; the placement against the
reference's rules; and the gated norm's mean over the whole of
``d_inner``."""
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
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pipeline import EdgeCloudPipeline  # noqa: E402
from repro_torch.core.stages import StageRunner  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       StatefulStageRunner,
                                       make_stateful_manager)
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.distributed.sharding import ShardingDegraded  # noqa: E402
from repro_torch.launch.mesh import (make_cloud_mesh,  # noqa: E402
                                     reset_mesh_devices, set_mesh_devices)
from repro_torch.params import from_numpy  # noqa: E402

SEQ = 12
TOL = dict(rtol=1e-4, atol=1e-4)       # the reference's own sharded bound
ARCHS = ("falcon-mamba-7b", "zamba2-7b", "qwen2-moe-a2.7b", "whisper-medium")
# leaves whose values the reference's init leaves at ones or zeros
_PERTURBED = ("scale", "bias", "norm", "D", "dt_bias", "conv_b", "bq", "bk",
              "bv")


@pytest.fixture(autouse=True)
def cpu_mesh():
    set_mesh_devices(["cpu"] * 8)
    try:
        yield
    finally:
        reset_mesh_devices()


def _configs(arch, **odd):
    """The reduced config in both packages with the fields ``odd``
    replaced (``ssm``/``moe`` given as dicts of their own fields)."""
    out = []
    for get in (get_config, tget):
        cfg = get(arch).reduced()
        kw = dict(odd)
        for sub in ("ssm", "moe"):
            if sub in kw:
                kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _weights(cfg):
    """The reference's init with its constant leaves moved off their
    initial values, so that every weight tells; as numpy arrays."""
    rng = np.random.default_rng(7)

    def perturb(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") in _PERTURBED:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(
        perturb, JT.init_model(cfg, jax.random.PRNGKey(0)))


def _inputs(cfg):
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (1, SEQ))}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (1, cfg.encoder.context_len, cfg.d_model)).astype(np.float32)
    return out


def make_pair(arch, **odd):
    """One set of weights and one request in both packages; the JAX
    runner's single-device logits at every position."""
    jcfg, tcfg = _configs(arch, **odd)
    npp = _weights(jcfg)
    inputs = _inputs(jcfg)
    jr = JRunner(jcfg, jax.tree.map(jax.numpy.asarray, npp))
    want = np.asarray(jr.run_units(inputs, 0, jr.num_units)["logits"])
    tr = StageRunner(tcfg, from_numpy(npp), attn_impl="kernel",
                     device="cpu")
    tin = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    return tr, tin, want


def _build(pipe, tin):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pipe.build(tin, cold=False)
    return [str(x.message) for x in w
            if issubclass(x.category, ShardingDegraded)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_executor_matches_reference_forward(arch, tp):
    """Every split's logits with the cloud stage on the mesh are the
    reference's single-device forward's; two requests on one mesh are
    bit-equal; nothing degrades at these widths."""
    tr, tin, want = make_pair(arch)
    cfg = tr.cfg
    for split in range(tr.num_units - 1):
        pipe = EdgeCloudPipeline(tr, split, NetworkModel(20.0),
                                 mesh_shape=(tp,))
        assert _build(pipe, tin) == []
        lay = pipe.cloud_params.layout
        assert (lay.mamba is not None) == (cfg.ssm is not None)
        assert (lay.heads is None) == (cfg.family == "ssm")
        assert (lay.experts is not None) == (cfg.family == "moe")
        got, _ = pipe.process(tin)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"split {split}")
        again, _ = pipe.process(tin)
        assert torch.equal(again, got)      # fixed all-reduce order
        pipe.close()


def test_mamba2_heads_that_do_not_divide_run_replicated():
    """zamba2 with 2 Mamba-2 heads on 4 shards: the Mamba block runs
    replicated with a warning, its shared attention stays head-parallel."""
    tr, tin, want = make_pair("zamba2-7b", ssm={"head_dim": 256})
    pipe = EdgeCloudPipeline(tr, 0, NetworkModel(20.0), mesh_shape=(4,))
    try:
        degraded = _build(pipe, tin)
        assert len(degraded) == 1 and "mamba2: heads=2 !% model=4" \
            in degraded[0]
        lay = pipe.cloud_params.layout
        assert lay.mamba is None and lay.heads is not None
        in_proj = pipe.cloud_params.shards[3]["layers"]["mamba"]["in_proj"]
        assert in_proj.shape == tr.params["layers"]["mamba"]["in_proj"].shape
        np.testing.assert_allclose(pipe.process(tin)[0].numpy(), want, **TOL)
    finally:
        pipe.close()


@pytest.mark.parametrize("cf", [None, 0.5])
def test_expert_count_that_does_not_divide_splits_each_expert(cf):
    """6 experts on 4 shards: tensor-parallel inside each expert (the
    reference's fallback, ``sharding.py``), with and without drops."""
    tr, tin, want = make_pair("qwen2-moe-a2.7b",
                              moe={"num_experts": 6, "capacity_factor": cf})
    pipe = EdgeCloudPipeline(tr, 0, NetworkModel(20.0), mesh_shape=(4,))
    try:
        assert _build(pipe, tin) == []
        lay = pipe.cloud_params.layout
        assert lay.experts is None and lay.expert_ff == (
            (0, 32), (32, 64), (64, 96), (96, 128))
        w_gate = pipe.cloud_params.shards[1]["layers"]["moe"]["w_gate"]
        assert w_gate.shape[-3:] == (6, 256, 32)
        np.testing.assert_allclose(pipe.process(tin)[0].numpy(), want, **TOL)
    finally:
        pipe.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_expert_parallel_with_capacity_drops(tp):
    """Capacity factor 0.5 drops assignments (the logits differ from the
    drop-free ones); every shard routes with the global expert counts,
    so the mesh drops the reference's assignments."""
    tr, tin, want = make_pair("qwen2-moe-a2.7b",
                              moe={"capacity_factor": 0.5})
    _, _, free = make_pair("qwen2-moe-a2.7b")
    assert np.abs(want - free).max() > 1e-2       # assignments dropped
    pipe = EdgeCloudPipeline(tr, 0, NetworkModel(20.0), mesh_shape=(tp,))
    try:
        _build(pipe, tin)
        assert pipe.cloud_params.layout.experts == TP._ranges(4, tp)
        np.testing.assert_allclose(pipe.process(tin)[0].numpy(), want, **TOL)
    finally:
        pipe.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_stateless_mesh_repartition_every_split(arch):
    """A ``PipelineManager`` moved onto a 2-way mesh, through every split
    on it under switch_b2 and switch_a (split 0: every decoder layer on
    the mesh, whisper's encoder context its boundary), and back: each
    request's logits are the reference's, and no weights move."""
    tr, tin, want = make_pair(arch)
    mgr = PipelineManager(tr, split=0, net=NetworkModel(20.0),
                          sample_inputs=tin)
    try:
        first, _ = mgr.serve(tin)
        mgr.set_mesh_shape((2,))
        rep = mgr.repartition("switch_b2", 0)
        assert rep.mesh_change and rep.new_mesh == (2,)
        for split in range(tr.num_units - 1):
            if split:
                mgr.drain()        # the last switch_a's re-armed standby
                mgr.build_standby(split)
                rep = mgr.repartition("switch_a", split)
                assert not rep.mesh_change and rep.new_split == split
            out, _ = mgr.serve(tin)
            np.testing.assert_allclose(out.numpy(), want, **TOL,
                                       err_msg=f"split {split}")
        mgr.set_mesh_shape(None)
        rep = mgr.repartition("switch_b2", 0)
        assert rep.mesh_change and rep.old_mesh == (2,)
        assert torch.equal(mgr.serve(tin)[0], first)
        assert [r.moved_bytes for r in mgr.pool.reshards] == [0, 0]
    finally:
        mgr.close()


def _cloud_state_bytes(pipe) -> int:
    sub = pipe.session.subset(pipe._u_edge, pipe._u_all)
    return sum(v.numel() * v.element_size() for v in sub.values())


@pytest.mark.parametrize("arch,layers", [("falcon-mamba-7b", 3),
                                         ("zamba2-7b", 4),
                                         ("qwen2-moe-a2.7b", 3)])
def test_stateful_mesh_roundtrip_decodes_identically(arch, layers):
    """Decode streams with and without a hop onto a 2-way mesh (and back)
    emit the same tokens; each transition moves the live cloud-range
    state at its logical size, conv and SSM state (and zamba2's shared
    blocks' KV) among it."""
    cfg = dataclasses.replace(tget(arch).reduced(), num_layers=layers)
    kw = dict(split=1, net=NetworkModel(50.0), prompt_len=8, max_seq=32,
              seed=3, device="cpu")
    mgr, sess = make_stateful_manager(cfg, **kw)
    try:
        ref = [mgr.serve(None)[0] for _ in range(6)]
        ref_toks = sess.tokens.clone()
    finally:
        mgr.close()
    mgr, sess = make_stateful_manager(cfg, **kw)
    try:
        out = [mgr.serve(None)[0] for _ in range(2)]
        mgr.set_mesh_shape((2,))
        mgr.repartition("switch_b2", 1)
        moved1 = mgr.pool.reshards[-1].moved_bytes
        assert moved1 == _cloud_state_bytes(mgr.active) > 0
        placed = {k: v for k, v in sess.cache.items()
                  if isinstance(v, TP.ShardedTensor)}
        assert set(placed) == set(mgr.active.session.subset(
            mgr.active._u_edge, mgr.active._u_all))
        if cfg.ssm is not None:
            conv = placed["conv1"]
            width = cfg.d_inner // 2 + (2 * cfg.ssm.d_state
                                        if cfg.ssm.kind == "mamba2" else 0)
            assert [t.shape[-1] for t in conv.shards] == [width, width]
            assert conv.shape[-1] == sess.cache["conv0"].shape[-1]
        out += [mgr.serve(None)[0] for _ in range(2)]
        mgr.set_mesh_shape(None)
        mgr.repartition("switch_b2", 1)
        assert mgr.pool.reshards[-1].moved_bytes == moved1
        assert not any(isinstance(v, TP.ShardedTensor)
                       for v in sess.cache.values())
        out += [mgr.serve(None)[0] for _ in range(2)]
        toks = sess.tokens.clone()
    finally:
        mgr.close()
    assert torch.equal(toks, ref_toks)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_mesh_transfer_payload_is_the_references(arch):
    """A transfer hand-off out of a mesh pipeline gathers its conv, SSM
    (and shared-attention KV) entries first: the same keys, shapes, dtypes
    and CRC32 as the JAX session's own export; its ``validate_payload``
    takes it, and the decode on the mesh agrees with the JAX session's."""
    jcfg, tcfg = _configs(arch, num_layers=4)
    params = JT.init_model(jcfg, jax.random.PRNGKey(0))
    jm, js = jax_manager(jcfg, params, split=1, net=JNet(50.0),
                         prompt_len=8, max_seq=32, seed=3)
    tm, ts = make_stateful_manager(
        tcfg, from_numpy(jax.tree.map(np.asarray, params)), split=1,
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
        L = jcfg.num_layers
        assert isinstance(ts.cache["ssm3"], TP.ShardedTensor)
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
            np.testing.assert_allclose(
                np.asarray(js.cache[k]), TP.whole(v, "cpu").numpy(),
                rtol=0, atol=0, err_msg=k)
        rep = tm.repartition("switch_b2", L)
        assert rep.handoff_mode == "transfer" and not rep.mesh_change
        assert not any(isinstance(v, TP.ShardedTensor)
                       for v in ts.cache.values())
        tok = np.asarray(js.next_token())
        want, _ = jm.serve({"token": tok})
        got, _ = tm.serve({"token": torch.tensor(tok)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    finally:
        jm.close()
        tm.close()


def test_gated_norm_mean_runs_over_all_of_d_inner(monkeypatch):
    """The Mamba-2 gated RMSNorm's mean is over every head: the executor
    matches the reference, and the same executor with each shard's mean
    over its own heads (the norm's all-reduce replaced by each shard's
    sum scaled up to the whole width) does not."""
    tr, tin, want = make_pair("zamba2-7b")
    pipe = EdgeCloudPipeline(tr, 0, NetworkModel(20.0), mesh_shape=(2,))
    try:
        _build(pipe, tin)
        np.testing.assert_allclose(pipe.process(tin)[0].numpy(), want, **TOL)
        real = TP.all_reduce

        def per_shard(parts, devices):
            if parts[0].shape[-1] == 1:      # the norm's sum of squares
                return [p * len(parts) for p in parts]
            return real(parts, devices)
        per_shard.calls = 0
        monkeypatch.setattr(TP, "all_reduce", per_shard)
        got = pipe.process(tin)[0].numpy()
        assert np.abs(got - want).max() > 100 * TOL["atol"]
    finally:
        pipe.close()


def _flat(tree) -> dict:
    out = {}
    TS.map_with_path(lambda n, t: out.__setitem__(n, t), tree)
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_is_the_references_rules(arch, tp):
    """Each shard's weights are the blocks the reference's
    ``param_shardings`` (no fsdp) gives it, but for the documented
    leaves: attention by heads, and ``in_proj`` (Mamba-2's ``conv_w`` and
    ``conv_b`` too) cut column group by column group: a shard's channels
    of ``x`` and of ``z`` (Mamba-2: of ``z``, ``x`` and ``dt``, beside the
    whole ``B`` and ``C``)."""
    jcfg, tcfg = _configs(arch)
    npp = _weights(jcfg)
    tparams = from_numpy(npp)
    mesh = make_cloud_mesh((tp,))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1] * tp), ("model",))
    specs = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            JS.param_shardings(jcfg, jmesh, npp, shard_fsdp=False))[0]:
        specs["/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                       for p in path)] = tuple(sh.spec)
    want = TS.shard_tree(tparams, TS.map_with_path(
        lambda n, _: TS.P(*specs[n]), tparams), mesh)
    tpp = TP.place_params(tcfg, tparams, mesh)
    whole = _flat(tparams)
    for i in range(tp):
        got, ref = _flat(tpp.shards[i]), _flat(want[i])
        assert got.keys() == ref.keys()
        for name, t in got.items():
            assert t.is_contiguous(), name
            leaf = name.rsplit("/", 1)[-1]
            if "attn/" in name:
                continue            # test_torch_sharding.py holds these
            if "mamba/" in name and leaf in ("in_proj", "conv_w", "conv_b"):
                w, di, s = whole[name], tcfg.d_inner, tcfg.ssm
                groups = [(0, di, True), (di, di, True)]
                if s.kind == "mamba2" and leaf == "in_proj":
                    groups = [(0, di, True), (di, di, True),
                              (2 * di, 2 * s.d_state, False),
                              (2 * di + 2 * s.d_state, di // s.head_dim,
                               True)]
                elif s.kind == "mamba2":
                    groups = [(0, di, True), (di, 2 * s.d_state, False)]
                elif leaf != "in_proj":
                    assert torch.equal(t, ref[name]), name
                    continue
                cols = []
                for o, n, cut in groups:
                    lo, hi = (o + i * n // tp, o + (i + 1) * n // tp) \
                        if cut else (o, o + n)
                    cols.append(w[..., lo:hi])
                assert torch.equal(t, torch.cat(cols, -1)), (name, i)
                continue
            assert torch.equal(t, ref[name]), (name, i)


def test_audio_stateful_stays_refused():
    """The stateful path refuses whisper with the reference's
    ``ValueError``, mesh or not."""
    cfg = dataclasses.replace(tget("whisper-medium").reduced(), num_layers=2)
    with pytest.raises(ValueError, match="stateful serving unsupported"):
        StatefulStageRunner(cfg, {}, max_seq=16, device="cpu")


@pytest.mark.parametrize("tp", [2, 4])
def test_cat_spec_round_trip(tp):
    """A ``sharding.Cat`` leaf: each shard holds its block of every column
    group side by side (a replicated group whole), and ``gather_tree``
    puts the leaf back."""
    t = torch.arange(3 * 20, dtype=torch.float32).reshape(3, 20)
    spec = TS.Cat((8, TS.P(None, "model")), (4, TS.P()),
                  (8, TS.P(None, "model")))
    mesh = make_cloud_mesh((tp,))
    parts = TS.shard_tree(t, spec, mesh)
    for i, part in enumerate(parts):
        c = 8 // tp
        assert torch.equal(part, torch.cat(
            [t[:, i * c:(i + 1) * c], t[:, 8:12],
             t[:, 12 + i * c:12 + (i + 1) * c]], -1))
    assert torch.equal(TS.gather_tree(parts, spec, mesh, "cpu", like=t), t)
