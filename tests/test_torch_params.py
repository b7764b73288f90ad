"""Weights across the packages: a JAX init_model pytree converts to the
port's tensors bit-exactly (f32), a repro.checkpoint .npz loads into the
port, and the port's own checkpoints round-trip (bf16 included)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.params import from_numpy, load_npz, unflatten  # noqa: E402


def _reduced(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _assert_tree_equal(t_tree, np_tree, path=""):
    if isinstance(np_tree, dict):
        assert set(t_tree) == set(np_tree), path
        for k in np_tree:
            _assert_tree_equal(t_tree[k], np_tree[k], f"{path}/{k}")
        return
    assert isinstance(t_tree, torch.Tensor), path
    assert tuple(t_tree.shape) == np_tree.shape, path
    np.testing.assert_array_equal(t_tree.numpy(), np_tree, err_msg=path)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("kv", [None, 2])
def test_reduced_configs_round_trip_bit_exact(arch, kv):
    cfg = _reduced(arch) if kv is None else _reduced(arch, num_kv_heads=kv)
    np_params = jax.tree.map(np.asarray,
                             JT.init_model(cfg, jax.random.PRNGKey(1)))
    t_params = from_numpy(np_params)
    _assert_tree_equal(t_params, np_params)


def test_from_numpy_copies():
    a = np.zeros(3, np.float32)
    t = from_numpy({"w": a})["w"]
    a[0] = 1.0
    assert t[0].item() == 0.0


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    cfg = _reduced("qwen2.5-3b")
    params = JT.init_model(cfg, jax.random.PRNGKey(2))
    path = str(tmp_path / "ckpt.npz")
    jax_save(params, path)
    _assert_tree_equal(load_npz(path), jax.tree.map(np.asarray, params))


def test_port_checkpoint_loads_into_jax(tmp_path):
    cfg = _reduced("qwen2.5-3b")
    np_params = jax.tree.map(np.asarray,
                             JT.init_model(cfg, jax.random.PRNGKey(3)))
    path = str(tmp_path / "ckpt.npz")
    save_pytree(from_numpy(np_params), path)
    back = jax_load(path, like=np_params)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(np_params)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(pa))


def test_bf16_checkpoint_round_trips_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"embed": torch.randn(8, 4, generator=g).bfloat16(),
            "layers": {"w": torch.randn(2, 4, 4, generator=g),
                       "b": torch.randn(2, 4, generator=g).bfloat16()}}
    path = str(tmp_path / "bf16.npz")
    save_pytree(tree, path)
    flat = load_pytree(path)
    assert flat["embed"].dtype == torch.bfloat16
    assert flat["layers/w"].dtype == torch.float32
    back = load_pytree(path, like=tree)
    for a, b in ((back["embed"], tree["embed"]),
                 (back["layers"]["w"], tree["layers"]["w"]),
                 (back["layers"]["b"], tree["layers"]["b"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(unflatten(flat)["layers"]["b"], tree["layers"]["b"])
