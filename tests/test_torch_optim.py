"""The port's AdamW, cosine schedule and global-norm clipping
(``repro_torch.optim``) against ``repro.optim`` on the same numpy
tensors, the twins of ``tests/test_training.py``'s optimizer tests, and
the reference's ``AdamWState`` carried across
(``repro_torch.params.adamw_state_from_numpy``).

Tolerances: the schedule's rates are f32 scalars computed as the
reference computes them, held to 1e-6 relative (XLA's f32 cosine and
numpy's may round an ulp apart, 1.2e-7); one AdamW update
and the clipped tensors to 1e-6 absolute (f32 arithmetic on values of
order 1, fused multiply-adds apart)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm_  # noqa: E402
from repro_torch.params import adamw_state_from_numpy  # noqa: E402


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "layers": {"b": (rng.standard_normal(7) * scale
                             ).astype(np.float32),
                       "s": (rng.standard_normal((3, 4, 2)) * scale
                             ).astype(np.float32)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _assert_tree_close(t, j, atol):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _assert_tree_close(t[k], j[k], atol)
        return
    assert tuple(t.shape) == tuple(np.shape(j))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 5), (0, 3),
                                          (4, 4)])
def test_cosine_schedule_matches_jax(warmup, total):
    jl = JO.cosine_schedule(3e-4, warmup=warmup, total=total)
    tl = TO.cosine_schedule(3e-4, warmup=warmup, total=total)
    for step in range(total + 3):
        assert tl(step) == pytest.approx(float(jl(step)), rel=1e-6,
                                         abs=0), step


def test_cosine_schedule_shape():
    lr = TO.cosine_schedule(1.0, warmup=10, total=100)
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1.0, abs=0.06)
    assert lr(100) == pytest.approx(0.0, abs=1e-3)
    assert lr(5) == pytest.approx(0.5, abs=0.01)


@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
def test_adamw_steps_match_jax(weight_decay):
    """Six updates under a schedule from the reference's initial state:
    params and both moments; decay only on leaves of ``ndim >= 2``."""
    sched = dict(base_lr=3e-2, warmup=2, total=6)
    jinit, jupdate = JO.adamw(weight_decay=weight_decay,
                              schedule=JO.cosine_schedule(**sched))
    tinit, tupdate = TO.adamw(weight_decay=weight_decay,
                              schedule=TO.cosine_schedule(**sched))
    jp = jax.tree.map(jnp.asarray, _tree(0))
    js = jinit(jp)
    tp = _torch_tree(_tree(0))
    ts = adamw_state_from_numpy(np.asarray(js.step),
                                jax.tree.map(np.asarray, js.m),
                                jax.tree.map(np.asarray, js.v))
    assert ts.step == 0
    _assert_tree_close(ts.m, jax.tree.map(np.asarray, js.m), 0.0)
    for i in range(6):
        g = _tree(10 + i, scale=0.1)
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = tupdate(_torch_tree(g), ts, tp)
        assert ts.step == int(js.step) == i + 1
        _assert_tree_close(tp, jax.tree.map(np.asarray, jp), 1e-6)
        _assert_tree_close(ts.m, jax.tree.map(np.asarray, js.m), 1e-6)
        _assert_tree_close(ts.v, jax.tree.map(np.asarray, js.v), 1e-6)


def test_adamw_update_is_in_place_and_keeps_dtype():
    init, update = TO.adamw(lr=0.1)
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": torch.ones(2)}
    state = init(params)
    assert state.m["w"].dtype == torch.float32
    w, b = params["w"], params["b"]
    new, state = update({"w": torch.ones(3, 2, dtype=torch.bfloat16),
                         "b": torch.ones(2)}, state, params)
    assert new["w"] is w and new["b"] is b
    assert w.dtype == torch.bfloat16
    # decay on the matrix only: 1 - 0.1 * (1 + 0.01) against 1 - 0.1 * 1
    assert float(b[0]) == pytest.approx(0.9, abs=1e-6)
    assert float(w[0, 0]) == pytest.approx(0.899, abs=4e-3)


def test_adamw_minimises_quadratic():
    init, update = TO.adamw(lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _tree(4)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                    max_norm)
    tc, tn = TO.clip_by_global_norm(_torch_tree(tree), max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    np.testing.assert_allclose(
        TO.global_norm(_torch_tree(tree)).item(),
        float(JO.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
    _assert_tree_close(tc, jax.tree.map(np.asarray, jc), 1e-6)
    # the train step's in-place twin: the same tensors, the same values
    inplace = _torch_tree(tree)
    n = clip_by_global_norm_(inplace, max_norm)
    assert n.item() == tn.item()
    _assert_tree_close(inplace, jax.tree.map(np.asarray, jc), 1e-6)


def test_clip_by_global_norm():
    tree = {"a": torch.ones(10) * 3.0}
    clipped, n = TO.clip_by_global_norm(tree, 1.0)
    assert TO.global_norm(clipped).item() == pytest.approx(1.0, rel=1e-4)
