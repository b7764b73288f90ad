"""The port's sharding rules, activation policy, cloud mesh, pool keys and
per-mesh latency model against the JAX package's.

The reference's rules run on a ``jax.sharding.Mesh`` over one CPU device
repeated (the rules read only the mesh's axis names and shape), the
port's on a ``CloudMesh`` over ``set_mesh_devices(["cpu"] * n)``: every
registered family's reduced config on meshes (2,), (4,), (8,) and (2, 4)
gives the same partition specs and the same ``ShardingDegraded``
warnings."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro.core.profiler as jprof  # noqa: E402
from repro.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.partitioner import optimal_split as j_optimal_split  # noqa: E402
from repro.core.pipeline import RequestTiming as JTiming  # noqa: E402
from repro.distributed import policy as jpolicy  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core.hardware import NVLINK_BW  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.partitioner import optimal_split  # noqa: E402
from repro_torch.core.pipeline import RequestTiming  # noqa: E402
from repro_torch.core.pool import PipelineKey, PipelinePool  # noqa: E402
from repro_torch.core.strategies import available_strategies  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.distributed import policy as tpolicy  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.launch.mesh import (make_cloud_mesh,  # noqa: E402
                                     make_host_mesh, reset_mesh_devices,
                                     set_mesh_devices)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.sim import SimPool, SimRunner  # noqa: E402

MESHES = [(2,), (4,), (8,), (2, 4)]
# reduced configs whose dims do not divide some meshes, so that the
# degraded-leaf warnings (and their "(+N more)" tails) are compared too
ODD = {"qwen2.5-3b": (("d_ff", 500), ("vocab_size", 510), ("head_dim", 36)),
       "falcon-mamba-7b": (("d_model", 250),),
       "zamba2-7b": (("d_model", 250),)}
CASES = [(arch, ()) for arch in ASSIGNED_ARCHS] + list(ODD.items())


@pytest.fixture
def cpu_mesh():
    """Eight shards on the CPU, cleared after the test."""
    set_mesh_devices(["cpu"] * 8)
    try:
        yield
    finally:
        reset_mesh_devices()


def jax_mesh(shape):
    axes = ("model",) if len(shape) == 1 else ("data", "model")
    devs = np.array([jax.devices()[0]] * int(np.prod(shape)))
    return Mesh(devs.reshape(shape), axes)


def specs_of(tree, jax_side: bool) -> dict:
    """{path: spec tuple} of a sharding tree."""
    out = {}
    if jax_side:
        for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                            for p in path)
            out[name] = tuple(sh.spec)
    else:
        TS.map_with_path(lambda n, sp: out.__setitem__(n, tuple(sp)), tree)
    return out


def degraded_messages(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w
                 if issubclass(x.category, UserWarning)
                 and "replicated" in str(x.message)]


@functools.lru_cache(maxsize=None)
def trees(arch, odd=()):
    """The reduced config's (with the fields ``odd`` replaced) param,
    cache and decode-state shapes in both packages (JAX: ``eval_shape``;
    the port: tensors on the CPU)."""
    jcfg = dataclasses.replace(get_config(arch).reduced(), **dict(odd))
    tcfg = dataclasses.replace(tget(arch).reduced(), **dict(odd))
    jparams = jax.eval_shape(lambda: JT.init_model(jcfg,
                                                   jax.random.PRNGKey(0)))
    tparams = T.init_model(tcfg, device="cpu")
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 1, 16))
    tcache = T.init_cache(tcfg, 1, 16, device="cpu")
    state = {}
    if tcfg.family == "hybrid":
        for g in range(tcache["attn"]["k"].shape[0]):
            state[f"ak{g}"] = tcache["attn"]["k"][g]
            state[f"av{g}"] = tcache["attn"]["v"][g]
    for i in range(tcfg.num_layers):
        if "mamba" in tcache:
            state[f"conv{i}"] = tcache["mamba"]["conv"][i]
            state[f"ssm{i}"] = tcache["mamba"]["ssm"][i]
        else:
            state[f"k{i}"] = tcache["k"][i]
            state[f"v{i}"] = tcache["v"][i]
    jstate = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in state.items()}
    return jcfg, tcfg, jparams, tparams, jcache, tcache, jstate, state


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch,odd", CASES)
def test_specs_and_degradations_equal_reference(cpu_mesh, arch, odd, shape):
    jcfg, tcfg, jparams, tparams, jcache, tcache, jstate, state = \
        trees(arch, odd)
    jm, tm = jax_mesh(shape), make_cloud_mesh(shape)
    assert tm.axis_names == tuple(jm.axis_names)
    seen = []
    for fsdp in (True, False):
        want, wmsg = degraded_messages(lambda: JS.param_shardings(
            jcfg, jm, jparams, shard_fsdp=fsdp))
        got, gmsg = degraded_messages(lambda: TS.param_shardings(
            tcfg, tm, tparams, shard_fsdp=fsdp))
        assert specs_of(got, False) == specs_of(want, True)
        assert gmsg == wmsg
        seen += gmsg
    want, wmsg = degraded_messages(
        lambda: JS.decode_state_shardings(jcfg, jm, jstate))
    got, gmsg = degraded_messages(
        lambda: TS.decode_state_shardings(tcfg, tm, state))
    assert specs_of(got, False) == specs_of(want, True) and gmsg == wmsg
    seen += gmsg
    for shp in ("decode_32k", "train_4k"):
        for layout in ("heads", "seq"):
            want = JS.cache_shardings(jcfg, jm, jcache, INPUT_SHAPES[shp],
                                      kv_layout=layout)
            got = TS.cache_shardings(tcfg, tm, tcache, INPUT_SHAPES[shp],
                                     kv_layout=layout)
            assert specs_of(got, False) == specs_of(want, True)
    inputs = {"tokens": np.zeros((2, 8), np.int32)}
    if tcfg.frontend == "vision":
        inputs["vision_embeds"] = np.zeros((2, 4, 16), np.float32)
    shape_in = INPUT_SHAPES["prefill_32k"]
    want = JS.input_shardings(jcfg, jm, inputs, shape_in)
    got = TS.input_shardings(tcfg, tm, inputs, shape_in)
    assert specs_of(got, False) == specs_of(want, True)
    assert tuple(TS.batch_spec(tm)) == tuple(JS.batch_spec(jm))
    assert TS.mesh_axes(tm) == JS.mesh_axes(jm)
    assert TS.should_shard_fsdp_serving(tget(arch), tm) == \
        JS.should_shard_fsdp_serving(get_config(arch), jm)
    if odd and shape == (8,):
        assert len(seen) == 3, "an odd config degrades params and state"


def test_shard_and_gather_tree_round_trip(cpu_mesh):
    """Each shard holds its spec's block as a contiguous tensor of its own;
    gathering puts the tree back bit-equal."""
    _, tcfg, _, tparams, *_ = trees("qwen2.5-3b")
    mesh = make_cloud_mesh((2, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        specs = TS.param_shardings(tcfg, mesh, tparams)
    shards = TS.shard_tree(tparams, specs, mesh)
    assert len(shards) == 8
    wq = tparams["layers"]["attn"]["wq"]
    part = shards[5]["layers"]["attn"]["wq"]          # data 1, model 1
    assert part.is_contiguous() and part.data_ptr() != wq.data_ptr()
    assert torch.equal(part, wq[:, 128:256, 64:128])
    back = TS.gather_tree(shards, specs, mesh, "cpu", like=tparams)
    flat_a, flat_b = {}, {}
    TS.map_with_path(lambda n, t: flat_a.__setitem__(n, t), tparams)
    TS.map_with_path(lambda n, t: flat_b.__setitem__(n, t), back)
    assert flat_a.keys() == flat_b.keys()
    assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)
    # a dim shorter than its axis is spread: 2 heads over 4 shards, each
    # held by 2 consecutive shards
    kv = torch.randn(1, 2, 16, 8)
    spec = TS.P(None, "model")
    parts = TS.shard_tree(kv, spec, make_cloud_mesh((4,)))
    assert [torch.equal(t, kv[:, i // 2:i // 2 + 1])
            for i, t in enumerate(parts)] == [True] * 4
    assert torch.equal(TS.gather_tree(parts, spec, make_cloud_mesh((4,)),
                                      "cpu", like=kv), kv)
    with pytest.raises(ValueError, match="does not split"):
        TS.shard_tree(torch.zeros(1, 3, 4), spec, make_cloud_mesh((2,)))


HEADS = [(4, 1), (8, 2), (8, 4), (8, 8), (6, 3)]


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-76b"])
def test_executor_placement_is_the_references_rules(cpu_mesh, arch, heads):
    """The tensor-parallel executor's weights on each shard are the blocks
    the reference's ``param_shardings`` (no fsdp) gives that shard, placed
    by ``shard_tree``, on every leaf but the documented ones: KV weights
    where ``num_kv_heads < tp`` (each KV head spread over the shards that
    read it, where the rules cut ``head_dim``), and the attention of heads
    that do not split (replicated, where the rules may cut columns)."""
    H, KH = heads
    odd = (("num_heads", H), ("num_kv_heads", KH))
    jcfg, tcfg, jparams, tparams, *_ = trees(arch, odd)
    hd = tcfg.head_dim
    for shape in MESHES:
        tp = shape[-1]
        mesh = make_cloud_mesh(shape)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rules = specs_of(JS.param_shardings(jcfg, jax_mesh(shape),
                                                jparams, shard_fsdp=False),
                             True)
            tpp = TP.place_params(tcfg, tparams, mesh)
        want = TS.shard_tree(
            tparams, TS.map_with_path(lambda n, _: TS.P(*rules[n]),
                                      tparams), mesh)[:tp]
        split = H % tp == 0 and (KH % tp == 0 or tp % KH == 0)
        assert (tpp.layout.heads is not None) == split
        odd_leaves = []
        for s in range(tp):
            got, ref, whole = ({}, {}, {})
            TS.map_with_path(lambda n, t: got.__setitem__(n, t),
                             tpp.shards[s])
            TS.map_with_path(lambda n, t: ref.__setitem__(n, t), want[s])
            TS.map_with_path(lambda n, t: whole.__setitem__(n, t), tparams)
            assert got.keys() == ref.keys()
            for name, t in got.items():
                assert t.is_contiguous()
                leaf = name.rsplit("/", 1)[-1]
                kv = leaf in ("wk", "wv", "bk", "bv")
                if "attn/" in name and not split:
                    odd_leaves.append(name)
                    assert torch.equal(t, whole[name]), name
                elif "attn/" in name and kv and KH < tp:
                    odd_leaves.append(name)
                    h = s * KH // tp
                    assert torch.equal(
                        t, whole[name][..., h * hd:(h + 1) * hd]), name
                else:
                    assert torch.equal(t, ref[name]), (name, shape, s)
        assert bool(odd_leaves) == (not split or KH < tp), (shape, heads)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_policy_choices_equal_reference(arch):
    jcfg, tcfg = get_config(arch), tget(arch)
    for tp in (1, 2, 4, 8, 16):
        for kind in ("train", "prefill", "decode"):
            for windowed in (False, True):
                assert tpolicy.choose_attn_mode(tcfg, tp, kind, windowed) \
                    == jpolicy.choose_attn_mode(jcfg, tp, kind, windowed)
    assert tpolicy.moe_groups() == jpolicy.moe_groups() == 1
    with tpolicy.policy(dp="data", tp="model", dp_size=4, attn="sequence"), \
            jpolicy.policy(dp="data", tp="model", dp_size=4,
                           attn="sequence"):
        assert tpolicy.moe_groups() == jpolicy.moe_groups() == 4
        assert tpolicy.attn_mode() == jpolicy.attn_mode() == "sequence"
    assert tpolicy.moe_groups() == 1 and tpolicy.attn_mode() == "heads"
    assert not hasattr(tpolicy, "constrain_qkv")


def test_cloud_mesh_rules_and_errors():
    reset_mesh_devices()
    for bad in ((), (0,), (2, 2, 2)):
        with pytest.raises(ValueError):
            make_cloud_mesh(bad)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="set_mesh_devices"):
            make_cloud_mesh((2,))
    set_mesh_devices(["cpu"] * 4)
    try:
        with pytest.raises(ValueError, match=r"needs 8 devices, 4 are"):
            make_cloud_mesh((2, 4))
        m = make_cloud_mesh((2, 2))
        assert m.axis_names == ("data", "model") and m.tp == 2
        assert m.devices == (torch.device("cpu"),) * 4
        m1 = make_cloud_mesh((3,))
        assert m1.axis_names == ("model",) and m1.size == 3
        assert m.key() != make_cloud_mesh((4,)).key()
    finally:
        reset_mesh_devices()
    h = make_host_mesh("cpu")
    assert h.shape == (1, 1) and h.axis_names == ("data", "model")


def test_pipeline_key_and_pool_keys_with_meshes():
    """The reference's key tests: shapes normalise to int tuples, and a
    pool's ``make_key`` fills its target mesh unless the caller pins one."""
    k = PipelineKey(split=3, mesh_shape=[2, 4])
    assert k.mesh_shape == (2, 4) and isinstance(k.mesh_shape, tuple)
    assert k == PipelineKey(split=3, mesh_shape=(2, 4))
    assert PipelineKey(split=3) != k
    pool = PipelinePool(SimRunner(8), NetworkModel(20.0), None,
                        mesh_shape=[2])
    assert pool.mesh_shape == (2,) and pool.make_key(1).mesh_shape == (2,)
    pool.set_mesh_shape(None)
    assert pool.make_key(1).mesh_shape is None
    pool.set_mesh_shape((4,))
    assert pool.make_key(1).mesh_shape == (4,)
    assert pool.make_key(1, mesh_shape=None).mesh_shape is None
    assert pool.make_key(1, mesh_shape=(2, 2)).mesh_shape == (2, 2)
    assert pool.take_last_reshard() is None and pool.reshards == []


def test_mesh_change_recorded_by_every_strategy():
    """set_mesh_shape + repartition (any strategy) -> the switch report
    carries the resharding wall and the mesh transition."""
    for name in sorted(available_strategies()):
        pool = SimPool(SimRunner(8), NetworkModel(20.0))
        mgr = PipelineManager(pool.runner, split=1, net=pool.net,
                              sample_inputs=None, pool=pool)
        try:
            mgr.set_mesh_shape((2,))
            mgr.build_standby(2)       # switch_a needs a live standby
            rep = mgr.repartition(name, 2)
            assert rep.old_mesh is None and rep.new_mesh == (2,), name
            assert rep.mesh_change and rep.t_reshard >= 0.0, name
            assert pool.reshards and \
                pool.reshards[-1].new_mesh == (2,), name
            # same mesh back-switch: no transition recorded
            rep2 = mgr.repartition(name if name != "switch_a"
                                   else "switch_b1", 1)
            assert not rep2.mesh_change and rep2.t_reshard == 0.0, name
        finally:
            mgr.close()


def test_mesh_latency_model_equals_reference(monkeypatch):
    """``mesh_cloud_time``, ``latency(mesh_shape=)``,
    ``optimal_split(mesh_shape=)`` and ``calibrate_mesh`` give the
    reference's numbers once its TPU link constant is the port's NVLink
    rate."""
    monkeypatch.setattr(jprof, "ICI_LINK_BW", NVLINK_BW)
    cfg_j, cfg_t = get_config("qwen2.5-3b"), tget("qwen2.5-3b")
    jp = jprof.profile_transformer(cfg_j, seq=1024)
    tp_ = tprof.profile_transformer(cfg_t, seq=1024)
    jnet, tnet = JNet(20.0), NetworkModel(20.0)
    for mesh in (None, (1,), (2,), (4,), (2, 4), (8,)):
        assert tp_.mesh_tp(mesh) == jp.mesh_tp(mesh)
        assert tp_.mesh_cloud_time(0.25, 3e6, mesh) == \
            pytest.approx(jp.mesh_cloud_time(0.25, 3e6, mesh), rel=1e-12)
        for split in range(tp_.num_splits()):
            assert tp_.latency(split, tnet, mesh) == pytest.approx(
                jp.latency(split, jnet, mesh), rel=1e-12)
            assert tp_.total_latency(split, tnet, mesh) == pytest.approx(
                jp.total_latency(split, jnet, mesh), rel=1e-12)
        assert optimal_split(tp_, tnet, mesh_shape=mesh).split == \
            j_optimal_split(jp, jnet, mesh_shape=mesh).split
    walls = [0.04, 0.05, 0.045]
    for mesh in ((2,), (4,)):
        got = tprof.calibrate_mesh(
            tp_, [RequestTiming(0.0, 0.0, w) for w in walls], split=9,
            mesh_shape=mesh)
        want = jprof.calibrate_mesh(
            jp, [JTiming(0.0, 0.0, w) for w in walls], split=9,
            mesh_shape=mesh)
        assert got == pytest.approx(want, rel=1e-12)
        assert tp_.latency(9, tnet, mesh) == pytest.approx(
            jp.latency(9, jnet, mesh), rel=1e-12)
    assert tprof.calibrate_mesh(tp_, [], split=3, mesh_shape=None) == \
        (1.0, 1.0)


@pytest.mark.parametrize("shape", [(2,), (2, 4)])
def test_stage_shardings_equal_reference(cpu_mesh, shape):
    """``StageRunner.stage_shardings``: the parameters' specs are
    ``param_shardings`` without fsdp, the boundary replicated."""
    from repro.core.stages import StageRunner as JRunner
    from repro_torch.core.stages import StageRunner, TensorSpec
    from repro_torch.params import from_numpy
    cfg = get_config("qwen2.5-3b").reduced()
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jr = JRunner(cfg, params)
    tr = StageRunner(tget("qwen2.5-3b").reduced(),
                     from_numpy(jax.tree.map(np.asarray, params)),
                     device="cpu")
    jstate = {"h": jax.ShapeDtypeStruct((1, 8, cfg.d_model), np.float32)}
    tstate = {"h": TensorSpec((1, 8, cfg.d_model), torch.float32,
                              torch.device("cpu"))}
    jp, js = jr.stage_shardings(jax_mesh(shape), jstate)
    tp_, ts = tr.stage_shardings(make_cloud_mesh(shape), tstate)
    assert specs_of(tp_, False) == specs_of(jp, True)
    assert specs_of(ts, False) == specs_of(js, True) == {"h": ()}
