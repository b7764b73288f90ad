"""The paper's own CNNs in the port against the JAX package on the same
weights: VGG19 and MobileNetV2 unit by unit against ``repro.models.cnn``
(each unit fed the reference's input to it), the same ``shapes`` and
boundary bytes, XLA's "SAME" padding at stride 2 on even and odd sizes,
and CNN params through the checkpoints of both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.stages import CnnStageRunner as JRunner  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import PAPER_ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.stages import CnnStageRunner  # noqa: E402
from repro_torch.models import cnn as TC  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

ATOL = 1e-4                     # tests/test_cnn_pipeline.py's tolerance
HW = {"mobilenetv2": 64, "vgg19": 32}


def _cfgs(arch):
    hw = HW[arch]
    return (dataclasses.replace(get_config(arch), input_hw=hw),
            dataclasses.replace(tget(arch), input_hw=hw))


@pytest.fixture(scope="module", params=PAPER_ARCHS)
def pair(request):
    """One set of weights (the reference's, seed 0) in both packages."""
    cfg, tcfg = _cfgs(request.param)
    jp, ju, js = JC.build_cnn(cfg, jax.random.PRNGKey(0))
    tr = CnnStageRunner(tcfg, from_numpy(jax.tree.map(np.asarray, jp)),
                        device="cpu")
    return cfg, (jp, ju, js), tr


def _image(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, cfg.input_hw, cfg.input_hw, cfg.input_ch), dtype=np.float32)


def test_units_match_reference(pair):
    cfg, (jp, ju, _), tr = pair
    assert [n for n, _ in tr.units] == [n for n, _ in ju]
    x = jnp.asarray(_image(cfg))
    for i, (name, fn) in enumerate(ju):
        want = fn(jp[i], x)
        got = tr.units[i][1](tr.params[i], torch.from_numpy(np.array(x)))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=name)
        x = want


def test_shapes_and_boundary_bytes_match_reference(pair):
    cfg, (_, _, js), tr = pair
    assert tr.shapes == js
    jr = JRunner(cfg, params=pair[1][0])
    for split in range(tr.num_units - 1):
        for batch in (1, 3):
            assert tr.boundary_bytes(split, batch) == \
                JC.boundary_bytes(js, split, batch) == \
                jr.boundary_bytes(split, batch)
        assert TC.boundary_bytes(tr.shapes, split, 2, 2) == \
            JC.boundary_bytes(js, split, 2, 2)
    assert not hasattr(tr, "edge_param_bytes")


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kind", ["conv", "dwconv"])
def test_stride2_same_padding_matches_xla(size, kind):
    """XLA pads (0, 1) at stride 2 on an even size, (1, 1) on an odd one;
    ``F.conv2d(padding=1)`` alone would shift the even case."""
    rng = np.random.default_rng(size)
    c = 4
    x = rng.standard_normal((2, size, size, c), dtype=np.float32)
    w = rng.standard_normal((3, 3, 1 if kind == "dwconv" else c, 6 if
                             kind == "conv" else c), dtype=np.float32)
    b = rng.standard_normal((w.shape[-1],), dtype=np.float32)
    jfn = JC._dwconv if kind == "dwconv" else JC._conv
    tfn = TC._dwconv if kind == "dwconv" else TC._conv
    want = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 2)
    got = tfn(torch.from_numpy(x), TC.conv_layout(torch.from_numpy(w)),
              torch.from_numpy(b), 2)
    assert tuple(got.shape) == want.shape == (2, (size + 1) // 2,
                                              (size + 1) // 2, w.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert TC.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))


def test_params_keep_reference_structure_and_place_once():
    _, tcfg = _cfgs("mobilenetv2")
    params, units, shapes = TC.build_cnn(tcfg)
    assert len(params) == len(units) == len(shapes) == len(tcfg.layers)
    assert params[9] == {} and params[10] == {}          # pool, flatten
    assert isinstance(params[2], list) and len(params[2]) == 2
    assert set(params[2][0]) == {"expand", "dw", "project"}
    assert "expand" not in params[1][0]                  # expand 1
    assert tuple(params[0]["w"].shape) == (3, 3, 3, 32)  # HWIO
    assert tuple(params[2][0]["dw"]["w"].shape) == (3, 3, 1, 96)
    assert tuple(params[11]["w"].shape) == (1280, 1000)  # (in, out)
    w = params[0]["w"]
    assert w.permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)
    again = TC.place_params(params, "cpu")
    assert again[0]["w"].data_ptr() == w.data_ptr()     # no second copy
    same, _, _ = TC.build_cnn(tcfg, torch.Generator().manual_seed(0))
    other, _, _ = TC.build_cnn(tcfg, torch.Generator().manual_seed(1))
    assert torch.equal(same[11]["w"], params[11]["w"])
    assert not torch.equal(other[11]["w"], params[11]["w"])


def test_checkpoint_round_trip_across_packages(tmp_path):
    """A CNN params list, ``{}`` entries included, through the port's
    ``save_pytree`` -> ``load_pytree(like=)`` (conv layout kept) and
    through a file either package wrote."""
    cfg, tcfg = _cfgs("mobilenetv2")
    jp, _, _ = JC.build_cnn(cfg, jax.random.PRNGKey(0))
    tr = CnnStageRunner(tcfg, from_numpy(jax.tree.map(np.asarray, jp)),
                        device="cpu")
    path = str(tmp_path / "port.npz")
    save_pytree(tr.params, path)
    back = load_pytree(path, like=tr.params)
    for i, (a, b) in enumerate(zip(back, tr.params)):
        if isinstance(b, dict) and not b:
            assert a == {}, i
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tr.params)):
        assert torch.equal(a, b) and a.stride() == b.stride()
    # the reference reloads the port's file, and the port the reference's
    jback = jax_load(path, like=jp)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jpath = str(tmp_path / "ref.npz")
    jax_save(jp, jpath)
    tback = load_pytree(jpath, like=tr.params)
    img = {"image": torch.from_numpy(_image(cfg))}
    assert torch.equal(tr._run(tback, img, 0, tr.num_units)["logits"],
                       tr.run_units(img, 0, tr.num_units)["logits"])
