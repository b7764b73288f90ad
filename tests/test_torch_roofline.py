"""The op counter (``repro_torch.distributed.op_analysis``), the roofline
(``distributed.roofline``) and the dry run (``launch.dryrun``) on the
CPU: the product-chain count, ``tp.all_reduce`` counted with its bytes,
each kernel wrapper's work read alike on CPU and meta tensors, the
derived all-reduces against what the tensor-parallel executor issues,
counted flops of reduced qwen2.5-3b steps within 5% of the reference's
``analyse_hlo_text`` on the same step compiled on one CPU device,
``model_flops_estimate`` against the reference's for all 39 pairs, the
depth extension against a direct count, ``run_pair`` on a small meta mesh
for each kind, and one full-size pair with the reference's record keys."""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import configs as RC  # noqa: E402
from repro.distributed import roofline as RR  # noqa: E402
from repro.distributed.hlo_analysis import analyse_hlo_text  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.specs import input_specs as jax_specs  # noqa: E402
from repro.training import steps as JS  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 InputShape, get_config, get_shape,
                                 pair_is_runnable)
from repro_torch.core.hardware import H100, NVLINK_BW  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pipeline import EdgeCloudPipeline  # noqa: E402
from repro_torch.core.stages import StageRunner  # noqa: E402
from repro_torch.core.stateful import make_stateful_manager  # noqa: E402
from repro_torch.distributed import tp as TP  # noqa: E402
from repro_torch.distributed.op_analysis import OpCounter, count  # noqa: E402
from repro_torch.distributed.roofline import (Roofline,  # noqa: E402
                                              kernel_roofline,
                                              model_flops_estimate,
                                              step_cost)
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ssd_scan as SD  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import (CloudMesh,  # noqa: E402
                                     make_production_mesh,
                                     reset_mesh_devices, set_mesh_devices)
from repro_torch.models import transformer as T  # noqa: E402

META = torch.device("meta")
PAIRS = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
         if pair_is_runnable(a, s)[0]]


@pytest.fixture
def cpu_mesh():
    set_mesh_devices(["cpu"] * 4)
    try:
        yield
    finally:
        reset_mesh_devices()


def test_product_chain_count():
    """Six chained 8 x 64 @ 64 x 64 products: 6 * 2 * 8 * 64 * 64 flops,
    their operands' and results' bytes, no collective on one device."""
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn((64, 64), generator=g) for _ in range(6)]

    def chain(x):
        for w in ws:
            x = x @ w
        return x
    for dev in ("cpu", "meta"):
        x = torch.randn((8, 64), generator=g).to(dev)
        _, c = count(chain, x) if dev == "cpu" else \
            count(lambda y: [y := y @ w.to(dev) for w in ws][-1], x)
        t = c.totals()
        assert t["flops"] == 6 * 2 * 8 * 64 * 64
        assert t["bytes"] == 6 * (8 * 64 + 64 * 64 + 8 * 64) * 4 \
            + (6 * 64 * 64 * 4 * 2 if dev == "meta" else 0)
        assert t["coll_bytes"] == 0 and not any(t["coll_counts"].values())
        assert t["peak_live_bytes"] >= 8 * 64 * 4


def test_all_reduce_counted_with_its_bytes(cpu_mesh):
    parts = [torch.ones((3, 5)), torch.full((3, 5), 2.0)]
    devs = [torch.device("cpu")] * 2
    calls = TP.all_reduce.calls
    with OpCounter() as c:
        out = TP.all_reduce(parts, devs)
    assert torch.equal(out[1], torch.full((3, 5), 3.0))
    t = c.totals()
    assert t["coll_counts"]["all-reduce"] == 1
    assert t["coll_by_kind"]["all-reduce"] == 3 * 5 * 4 == t["coll_bytes"]
    assert t["flops"] == 0 and t["ops"] == 0    # its copies are not counted
    assert TP.all_reduce.calls == calls + 1


def _kernel_calls():
    g = torch.Generator().manual_seed(1)

    def r(*s, dt=torch.bfloat16):
        return torch.randn(s, generator=g).to(dt)
    S = 48
    yield "flash_decode_attention", FD.flash_decode_attention, \
        (r(2, 1, 8, 64), r(2, 2, S, 64), r(2, 2, S, 64)), \
        {"pos": torch.tensor(S)}
    yield "flash_attention", FA.flash_attention, \
        (r(2, 40, 8, 64), r(2, 40, 2, 64), r(2, 40, 2, 64)), \
        {"causal": True, "window": 16}
    yield "mamba1_scan", MS.mamba1_scan, \
        (r(1, 70, 32), r(1, 70, 16), r(1, 70, 16), r(1, 70, 32),
         r(32, 16, dt=torch.float32), r(1, 32, 16, dt=torch.float32)), {}
    yield "ssd_scan", SD.ssd_scan, \
        (r(1, 65, 4, dt=torch.float32), r(1, 65, 16), r(1, 65, 16),
         r(1, 65, 4, 8), r(4, dt=torch.float32)), {}


@pytest.mark.parametrize("name", ["flash_decode_attention",
                                  "flash_attention", "mamba1_scan",
                                  "ssd_scan"])
def test_kernel_work_reads_alike_on_cpu_and_meta(name):
    """A wrapper counts its kernel's formula and none of the operators it
    dispatches, so its plain version on the CPU and shape inference on
    meta read the same work; a full-cache ``pos`` on meta reads as the
    whole cache."""
    _, fn, args, kw = next(c for c in _kernel_calls() if c[0] == name)
    got = {}
    for dev in ("cpu", "meta"):
        a = [t.to(dev) for t in args]
        k = {key: (v.to(dev) if isinstance(v, torch.Tensor) else v)
             for key, v in kw.items()}
        with OpCounter() as c:
            fn(*a, **k)
        got[dev] = c.totals()
        assert got[dev]["kernel_calls"] == {name: 1}
        assert got[dev]["ops"] == 0
    for key in ("flops", "bytes", "kernel_flops", "kernel_bytes"):
        assert got["cpu"][key] == got["meta"][key] > 0, key
    mod = {"flash_decode_attention": FD, "flash_attention": FA,
           "mamba1_scan": MS, "ssd_scan": SD}[name]
    assert (got["cpu"]["flops"], got["cpu"]["bytes"]) == mod.work(*args, **kw)


FAMILIES = ("qwen2.5-3b", "falcon-mamba-7b", "zamba2-7b", "qwen2-moe-a2.7b",
            "whisper-medium")


def _request(cfg, S=12):
    g = torch.Generator().manual_seed(5)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (1, S), generator=g)}
    if cfg.frontend == "audio":
        out["frames"] = torch.randn((1, cfg.encoder.context_len,
                                     cfg.d_model), generator=g)
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_derived_all_reduces_equal_the_executors(arch, tp, cpu_mesh):
    """A full pass with every decoder layer on the mesh issues the
    all-reduces ``layer_all_reduces`` derives, count and bytes."""
    cfg = get_config(arch).reduced()
    params = T.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    runner = StageRunner(cfg, params, attn_impl="kernel", device="cpu")
    req = _request(cfg)
    pipe = EdgeCloudPipeline(runner, 0, NetworkModel(20.0),
                             mesh_shape=(tp,))
    pipe.build(req, cold=False)
    with OpCounter() as c:
        pipe.process(req)
    t = c.totals()
    n, b = DR.layer_all_reduces(cfg, tp, 12, itemsize=4)
    assert (t["coll_counts"]["all-reduce"], t["coll_by_kind"]["all-reduce"]) \
        == (n, b) and n > 0
    pipe.close()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES[:4])
def test_derived_all_reduces_equal_a_mesh_decode_step(arch, tp, cpu_mesh):
    """One decode step with layers [1, L) on the mesh."""
    cfg = get_config(arch).reduced()
    mgr, _ = make_stateful_manager(cfg, split=1, net=NetworkModel(50.0),
                                   prompt_len=8, max_seq=32, seed=3,
                                   device="cpu")
    try:
        mgr.set_mesh_shape((tp,))
        mgr.repartition("switch_b2", 1)
        with OpCounter() as c:
            mgr.serve(None)
    finally:
        mgr.close()
    t = c.totals()
    n, b = DR.layer_all_reduces(cfg, tp, 1, itemsize=4,
                                layers=range(1, cfg.num_layers))
    assert (t["coll_counts"]["all-reduce"], t["coll_by_kind"]["all-reduce"]) \
        == (n, b) and n > 0


def _reference_flops(cfg, shape) -> float:
    """``analyse_hlo_text``'s flops of the reference's step for ``shape``,
    compiled on one CPU device."""
    params = jax.eval_shape(lambda: JT.init_model(cfg, jax.random.PRNGKey(0)))
    specs, cache = jax_specs(cfg, shape, dtype=jnp.float32)
    if shape.kind == "prefill":
        fn = jax.jit(JS.make_prefill_step(cfg, shape))
        lowered = fn.lower(params, specs)
    else:
        fn = jax.jit(JS.make_serve_step(cfg, shape))
        lowered = fn.lower(params, specs["token"], cache)
    return analyse_hlo_text(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_counted_flops_within_5pct_of_the_hlo_analysis(kind):
    jcfg = RC.get_config("qwen2.5-3b").reduced()
    cfg = get_config("qwen2.5-3b").reduced()
    jshape = dataclasses.replace(RC.get_shape(f"{kind}_32k"), seq_len=64,
                                 global_batch=2)
    shape = InputShape(jshape.name, 64, 2, kind)
    want = _reference_flops(jcfg, jshape)
    got = DR.count_step(cfg, shape)["flops"]
    assert want > 0
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_model_flops_estimate_equals_the_references():
    for a, s in PAIRS:
        assert model_flops_estimate(get_config(a), get_shape(s)) == \
            RR.model_flops_estimate(RC.get_config(a), RC.get_shape(s)), (a, s)


@pytest.mark.parametrize("arch,layers,enc,kinds", [
    ("qwen2.5-3b", 5, None, ("train", "prefill", "decode")),
    ("qwen2-moe-a2.7b", 3, None, ("train",)),
    ("zamba2-7b", 5, None, ("prefill", "decode")),
    ("whisper-medium", 2, 3, ("prefill",))])
def test_depth_extension_equals_the_direct_count(arch, layers, enc, kinds):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    if enc:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, num_layers=enc))
    for kind in kinds:
        shape = InputShape(kind, 16, 1, kind)
        want = DR.count_step(cfg, shape)
        got = DR.counted_totals(cfg, shape)
        for key in ("flops", "bytes", "ops", "kernel_flops", "kernel_bytes"):
            assert got[key] == want[key], (kind, key)
        assert got["kernel_calls"] == want["kernel_calls"], kind


def test_production_mesh_is_the_references_shape():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.size) == (("data", "model"),
                                                     (16, 16), 256)
    assert (two.axis_names, two.shape, two.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert all(d.type == "meta" for d in one.devices + two.devices)


@pytest.mark.parametrize("arch,kind", [
    ("qwen2.5-3b", "train"), ("falcon-mamba-7b", "prefill"),
    ("zamba2-7b", "decode"), ("qwen2-moe-a2.7b", "train"),
    ("whisper-medium", "prefill"), ("internvl2-76b", "decode")])
def test_run_pair_on_a_small_meta_mesh(arch, kind, tmp_path):
    cfg = get_config(arch).reduced()
    mesh = CloudMesh(("data", "model"), (2, 2), (META,) * 4)
    shape = InputShape(f"{kind}_small", 32, 4, kind)
    rec = DR.run_pair(arch, shape, multi_pod=False, out_dir=str(tmp_path),
                      cfg=cfg, mesh=mesh)
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["device_spec"] == "h100_sxm" and rec["hlo_flops"] > 0
    assert rec["coll_breakdown"]["derived"]
    assert rec["coll_bytes"] > 0 and rec["per_device_bytes"] > 0
    assert rec["t_compute"] == pytest.approx(
        rec["hlo_flops"] / (4 * H100.flops))
    assert rec["t_collective"] == pytest.approx(
        rec["coll_bytes"] / (4 * NVLINK_BW))
    path = tmp_path / f"{arch}--{kind}_small--pod.json"
    assert json.loads(path.read_text())["arch"] == arch


def test_a_full_size_pair_in_under_10_s_with_the_references_keys(tmp_path):
    t0 = time.perf_counter()
    rec = DR.run_pair("qwen2.5-3b", "decode_32k", multi_pod=False,
                      out_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 10
    keys = {f.name for f in dataclasses.fields(RR.Roofline)} \
        | {"compile_s", "policy", "tag"}
    assert keys <= set(rec)
    assert rec["device_spec"] == "h100_sxm" and rec["chips"] == 256
    assert rec["mesh"] == "16x16" and rec["bottleneck"] == "memory"
    assert rec["counted"]["extended_from_shallow_depths"]


def test_kernel_roofline_and_step_cost():
    w = torch.randn((64, 64))
    cost = step_cost(lambda x: x @ w, torch.randn((8, 64)))
    assert cost["flops"] == 2 * 8 * 64 * 64
    assert cost["bytes accessed"] == (8 * 64 + 64 * 64 + 8 * 64) * 4
    kr = kernel_roofline("mm", wall_s=1e-6, cost=cost)
    assert kr.device_spec == "h100_sxm" and kr.bound == "memory"
    assert kr.flops_frac == pytest.approx(cost["flops"] / 1e-6 / H100.flops)
    rl = Roofline("a", "s", "1", 1, 1e12, 1e9, 0.0, {}, 5e11).finish()
    assert rl.bottleneck == "compute" and rl.useful_flops_frac == 0.5
