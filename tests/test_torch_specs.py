"""The dry run's inputs and the meta device: every runnable (arch x
shape) pair's ``repro_torch.models.specs.input_specs`` against the
reference's ``ShapeDtypeStruct``s leaf by leaf, the ring bound, the long
context's per-device cache on the H100, ``concrete_inputs``, the models
and caches built on meta with no storage, the MoE's expert counts without
``bincount`` (bit-equal to it), and the kernel wrappers' shape inference
on meta tensors."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import configs as RC  # noqa: E402
from repro.models import specs as RS  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 get_config, get_shape, pair_is_runnable)
from repro_torch.core.hardware import H100  # noqa: E402
from repro_torch.distributed.sharding import cache_shardings  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ssd_scan as SD  # noqa: E402
from repro_torch.launch.dryrun import per_device_bytes  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.specs import concrete_inputs, input_specs  # noqa: E402

PAIRS = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
         if pair_is_runnable(a, s)[0]]
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def _flat(tree, prefix=()):
    """``{path: leaf}`` of a nested dict (sorted keys, as JAX flattens)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _jax_flat(tree):
    return {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_exactly_39_runnable_pairs_as_the_reference():
    assert len(PAIRS) == 39
    for a in ASSIGNED_ARCHS:
        for s in INPUT_SHAPES:
            assert pair_is_runnable(a, s) == RC.pair_is_runnable(a, s)
    assert not pair_is_runnable("vgg19", "train_4k")[0]


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_input_specs_equal_the_references(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    want_in, want_cache = RS.input_specs(RC.get_config(arch),
                                         RC.get_shape(shape_name),
                                         dtype=jnp.bfloat16)
    got_in, got_cache = input_specs(cfg, shape, dtype=torch.bfloat16)
    pairs = [(got_in, want_in)]
    if want_cache is not None:
        pairs.append((got_cache, want_cache))
    else:
        assert got_cache is None
    for got, want in pairs:
        g, w = _flat(got), _jax_flat(want)
        assert set(g) == set(w)
        for path, leaf in w.items():
            assert g[path].is_meta, path
            assert tuple(g[path].shape) == tuple(leaf.shape), path
            assert g[path].dtype == DTYPES[jnp.dtype(leaf.dtype)], path
    if shape.kind == "decode":          # the ring never exceeds the window
        w = T.effective_window(cfg, shape.seq_len)
        for path, leaf in _flat(got_cache).items():
            if leaf.dim() == 5:
                assert leaf.shape[3] <= (w or shape.seq_len), path


def test_long500k_cache_fits_h100():
    """The twin of the reference's v5e bound: the long_500k rings over 256
    chips each fit an H100, and so does every arch's per-device share
    under the production rules."""
    shape = get_shape("long_500k")
    mesh = make_production_mesh()
    for arch in ("zamba2-7b", "falcon-mamba-7b", "mixtral-8x22b", "yi-34b"):
        cfg = get_config(arch)
        _, cache = input_specs(cfg, shape, dtype=torch.bfloat16)
        total = sum(t.numel() * t.element_size()
                    for t in _flat(cache).values())
        assert total / 256 < H100.mem_bytes, arch
        specs = cache_shardings(cfg, mesh, cache, shape)
        assert per_device_bytes(cache, specs, mesh) < H100.mem_bytes, arch


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2.5-3b", "decode_32k"), ("internvl2-76b", "prefill_32k"),
    ("whisper-medium", "train_4k")])
def test_concrete_inputs_match_the_specs(arch, shape_name):
    cfg = get_config(arch).reduced()
    shape = dataclasses.replace(get_shape(shape_name), seq_len=64,
                                global_batch=2)
    got, cache = concrete_inputs(cfg, shape,
                                 torch.Generator().manual_seed(3),
                                 device="cpu")
    again, _ = concrete_inputs(cfg, shape, torch.Generator().manual_seed(3),
                               device="cpu")
    specs, cache_spec = input_specs(cfg, shape, dtype=torch.float32)
    assert set(got) == set(specs)
    for k, t in got.items():
        assert t.device.type == "cpu" and not t.is_meta
        assert t.shape == specs[k].shape and t.dtype == specs[k].dtype
        assert torch.equal(t, again[k])
        if t.dtype == torch.int32:
            assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
    if cache_spec is not None:
        fc, fs = _flat(cache), _flat(cache_spec)
        assert set(fc) == set(fs)
        assert all(fc[p].shape == fs[p].shape for p in fs)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "falcon-mamba-7b",
                                  "zamba2-7b", "qwen2-moe-a2.7b",
                                  "whisper-medium", "internvl2-76b"])
def test_models_and_caches_build_on_meta(arch):
    """``init_model``/``init_cache`` on meta: no generator, no storage,
    the CPU build's keys, shapes and dtypes."""
    cfg = get_config(arch).reduced()
    meta = _flat(T.init_model(cfg, dtype=torch.bfloat16, device="meta"))
    cpu = _flat(T.init_model(cfg, torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16, device="cpu"))
    assert set(meta) == set(cpu)
    for p, t in cpu.items():
        assert meta[p].is_meta and meta[p].shape == t.shape \
            and meta[p].dtype == t.dtype, p
    cm = _flat(T.init_cache(cfg, 2, 32, dtype=torch.bfloat16,
                            device="meta"))
    cc = _flat(T.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cpu"))
    assert set(cm) == set(cc)
    assert all(cm[p].is_meta and cm[p].shape == cc[p].shape
               and cm[p].dtype == cc[p].dtype for p in cc)


@pytest.mark.parametrize("E,n", [(4, 0), (8, 1), (60, 4096), (7, 333)])
def test_expert_counts_bit_equal_to_bincount(E, n):
    g = torch.Generator().manual_seed(E + n)
    e = torch.randint(0, E, (n,), generator=g)
    got = L.expert_counts(e, E)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.bincount(e, minlength=E))
    meta = L.expert_counts(e.to("meta"), E)
    assert meta.is_meta and meta.shape == (E,)


def test_moe_layer_runs_on_meta():
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    p = T.layer_params(T.init_model(cfg, dtype=torch.bfloat16,
                                    device="meta"), 0)["moe"]
    x = torch.empty((2, 16, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    y, aux = L.moe_layer(p, x, top_k=cfg.moe.top_k)
    assert y.is_meta and y.shape == x.shape and aux.shape == ()


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


def test_kernel_wrappers_infer_shapes_on_meta():
    """On meta tensors each wrapper returns its kernel's output shapes and
    dtypes and launches nothing; mixed devices still raise."""
    g = torch.Generator().manual_seed(0)

    def r(*s, dt=torch.bfloat16):
        return torch.randn(s, generator=g).to(dt)
    q, kc, vc = r(2, 1, 8, 64), r(2, 2, 32, 64), r(2, 2, 32, 64)
    before = FD.flash_decode_attention.launches
    out = FD.flash_decode_attention(*_meta(q, kc, vc),
                                    pos=torch.tensor(5).to("meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert FD.flash_decode_attention.launches == before
    q, k, v = r(2, 16, 8, 64), r(2, 16, 2, 64), r(2, 16, 2, 64)
    out = FA.flash_attention(*_meta(q, k, v))
    assert out.is_meta and out.shape == q.shape
    dt, Bc, x = r(1, 8, 32), r(1, 8, 16), r(1, 8, 32)
    A = r(32, 16, dt=torch.float32)
    y, h = MS.mamba1_scan(*_meta(dt, Bc, Bc, x, A))
    assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
    assert h.shape == (1, 32, 16) and h.dtype == torch.float32
    dt, Bc, x, A = (r(1, 8, 4, dt=torch.float32), r(1, 8, 16),
                    r(1, 8, 4, 8), r(4, dt=torch.float32))
    y, h = SD.ssd_scan(*_meta(dt, Bc, Bc, x, A))
    assert y.is_meta and y.shape == x.shape
    assert h.shape == (1, 4, 8, 16) and h.dtype == torch.float32
    with pytest.raises(ValueError):
        FA.flash_attention(q.to("meta"), k, v)
    with pytest.raises(ValueError):
        SD.ssd_scan(dt, Bc, Bc, x.to("meta"), A)


def test_ssm_prefill_and_decode_run_on_meta():
    """The SSM and hybrid families' scans take the wrappers' meta path."""
    for arch in ("falcon-mamba-7b", "zamba2-7b"):
        cfg = get_config(arch).reduced()
        p = T.init_model(cfg, dtype=torch.bfloat16, device="meta")
        tokens = torch.empty((2, 16), dtype=torch.int32, device="meta")
        logits, cache = T.prefill(cfg, p, {"tokens": tokens}, max_seq=32)
        assert logits.is_meta and logits.shape == (2, cfg.vocab_size)
        logits, _ = T.decode_step(cfg, p, tokens[:, :1], cache)
        assert logits.is_meta and logits.shape == (2, cfg.vocab_size)
