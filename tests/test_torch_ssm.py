"""The port's mamba blocks against the JAX package on the same weights:
``causal_conv1d``, ``mamba1_block`` and ``mamba2_block`` with and without a
decode cache (the kernel route, whose wrappers run the plain versions on
the CPU, against the reference's jnp and Pallas routes), and
``init_model`` of reduced falcon-mamba-7b and zamba2-7b: the same keys,
shapes and dtypes as JAX's, carried across bit for bit in f32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

ARCHS = {"mamba1": "falcon-mamba-7b", "mamba2": "zamba2-7b"}


def _cfgs(kind):
    return get_config(ARCHS[kind]).reduced(), tget(ARCHS[kind]).reduced()


def _block_params(kind, seed=0):
    """One layer's mamba weights from JAX's init, in both frameworks."""
    cfg, tcfg = _cfgs(kind)
    init = JSSM.init_mamba1 if kind == "mamba1" else JSSM.init_mamba2
    params = init(cfg, jax.random.PRNGKey(seed), jnp.float32)
    # non-zero biases and norm so every term is exercised
    rng = np.random.default_rng(seed)
    params = dict(params)
    params["conv_b"] = jnp.asarray(
        rng.standard_normal(params["conv_b"].shape).astype(np.float32) * .1)
    if "norm" in params:
        params["norm"] = jnp.asarray(1 + 0.1 * rng.standard_normal(
            params["norm"].shape).astype(np.float32))
    return cfg, tcfg, params, from_numpy(jax.tree.map(np.asarray, params))


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    jy, jst = JSSM.causal_conv1d(x, w, b, st)
    ty, tst = SSM.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)),
                                None if st is None else torch.from_numpy(st))
    _close(ty, jy, 1e-6)
    assert torch.equal(tst, torch.from_numpy(np.array(jst)))


def test_causal_conv1d_keeps_bf16_and_its_trailing_inputs():
    x = torch.randn(1, 5, 8, generator=torch.Generator().manual_seed(0))
    xb = x.bfloat16()
    y, st = SSM.causal_conv1d(xb, torch.ones(2, 8).bfloat16(),
                              torch.zeros(8).bfloat16())
    assert y.dtype == st.dtype == torch.bfloat16
    assert torch.equal(st, xb[:, -1:])          # K - 1 = 1 trailing input


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
@pytest.mark.parametrize("cached", [False, True])
def test_block_matches_jax(kind, cached):
    """A prompt through the block (no cache), then, with ``cached``, one
    decode step from the prompt's cache: against the reference's jnp and
    Pallas routes, outputs at 1e-4 and the new cache at 1e-5."""
    cfg, tcfg, jp, tp = _block_params(kind)
    jblock = JSSM.mamba1_block if kind == "mamba1" else JSSM.mamba2_block
    tblock = SSM.mamba1_block if kind == "mamba1" else SSM.mamba2_block
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jout, jcache = jblock(jp, jnp.asarray(x), cfg=cfg)
    tout, tcache = tblock(tp, torch.from_numpy(x), cfg=tcfg)
    _close(tout, jout, 1e-4)
    if cached:
        step = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        for impl in ("jnp", "pallas"):
            jout, jnew = jblock(jp, jnp.asarray(step), jcache, cfg=cfg,
                                impl=impl)
            tout, tnew = tblock(tp, torch.from_numpy(step), tcache,
                                cfg=tcfg)
            _close(tout, jout, 1e-4)
            _close(tnew["conv"], jnew["conv"], 1e-5)
            _close(tnew["ssm"], jnew["ssm"], 1e-5)
        return
    assert set(tcache) == {"conv", "ssm"}
    _close(tcache["conv"], jcache["conv"], 1e-5)
    _close(tcache["ssm"], jcache["ssm"], 1e-5)
    assert tcache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_block_keeps_the_reference_dtypes_in_bf16(kind):
    """bf16 activations: the block's output and conv state in bf16, the SSM
    state in f32, and the kernel route equal to the plain route on the
    CPU (the wrapper runs the plain version there)."""
    _, tcfg = _cfgs(kind)
    params = init_model(dataclasses.replace(tcfg, num_layers=1),
                        dtype=torch.bfloat16, device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    for k in ("dt_bias", "A_log", "D"):
        assert lp[k].dtype == torch.float32
    x = torch.randn(1, 6, tcfg.d_model,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    out, cache = SSM.ssm_block(tcfg, lp, x)
    assert out.dtype == cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    plain, pcache = SSM.ssm_block(tcfg, lp, x, impl="plain")
    assert torch.equal(out, plain)
    assert torch.equal(cache["ssm"], pcache["ssm"])


def _tree(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_model_matches_jax_layout(arch, dtype):
    """The port's init has JAX's keys, shapes and dtypes (mixed in bf16:
    the mamba blocks' dt_bias, A_log and D stay f32), and its constant
    leaves hold JAX's values (A_log to the last bit of a log: the two
    libraries' logs round differently)."""
    cfg = get_config(arch).reduced()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = dict(_tree(JT.init_model(cfg, jax.random.PRNGKey(0), jd)))
    tp = dict(_tree(init_model(tget(arch).reduced(), dtype=td,
                               device="cpu")))
    assert set(tp) == set(jp)
    for k, a in jp.items():
        t = tp[k]
        assert tuple(t.shape) == a.shape, k
        assert str(t.dtype).split(".")[-1] == str(a.dtype), k
        if k.endswith(("A_log", "/D", "conv_b", "scale", "norm")):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(a, np.float32), rtol=2e-7,
                                       atol=0, err_msg=k)
    if arch == "zamba2-7b":
        assert tp["/shared/attn/wq"].dim() == 2      # one layer, unstacked


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_params_carry_across_bit_exact(arch, dtype):
    """params.from_numpy carries a JAX init_model pytree of the family
    across leaf by leaf, bit for bit: in f32, and in bf16 with the
    mamba blocks' f32 leaves (mixed dtypes)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=3)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(np.asarray, JT.init_model(cfg, jax.random.PRNGKey(4),
                                                jd))
    tp = from_numpy(jp)
    for (path, t), (_, a) in zip(_tree(tp), _tree(jp)):
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        if t.dtype == torch.bfloat16:
            t, a = t.view(torch.int16), a.view(np.int16)
        np.testing.assert_array_equal(t.numpy(), a, err_msg=path)
