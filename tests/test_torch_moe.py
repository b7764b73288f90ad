"""The port's ``moe_layer`` against ``repro.models.layers.moe_layer`` on the
same weights and inputs (numpy from a seed): f32 to 1e-4, bf16 to 2e-2 of
the largest output, with no-drop dispatch (``capacity_factor`` None) and
the configured 1.25 at token counts where experts overflow, shared
experts on and off, and the Switch-style aux loss.  Both of the port's
expert layouts are exercised: the reference's (E, C, D) slots (many
tokens) and one product per assignment (T * K <= E / 2, a decode step)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

D, F_EXP, F_SHARED = 32, 24, 40


def _params(E, shared, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.3):
        return (rng.standard_normal(shape) * std).astype(dtype)
    p = {"router": (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
         "w_gate": n(E, D, F_EXP), "w_up": n(E, D, F_EXP),
         "w_down": n(E, F_EXP, D)}
    if shared:
        p.update(shared_w_gate=n(D, F_SHARED), shared_w_up=n(D, F_SHARED),
                 shared_w_down=n(F_SHARED, D))
    return p


def _x(B, S, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(dtype)


def _both(p, x, **kw):
    jy, jaux = JL.moe_layer({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), **kw)
    ty, taux = TL.moe_layer(from_numpy(p), from_numpy(x), **kw)
    return (ty.float().numpy(), taux.item(),
            np.asarray(jy.astype(jnp.float32)), float(jaux))


def _dropped(p, x, top_k, cf):
    """Assignments over their expert's capacity, by the reference's rule
    (stable sort by expert id: the latest tokens overflow)."""
    E = p["router"].shape[1]
    xf = x.reshape(-1, D).astype(np.float32)
    logits = xf @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k].reshape(-1)
    C = TL.moe_capacity(xf.shape[0], top_k, E, cf)
    seen = np.zeros(E, int)
    drops = 0
    for e in idx:
        seen[e] += 1
        drops += seen[e] > C
    return drops


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cf", [None, 1.25])
@pytest.mark.parametrize("B,S,E,K", [(2, 24, 4, 2), (1, 40, 8, 2),
                                     (3, 16, 6, 3), (1, 1, 8, 2),
                                     (2, 1, 16, 4)])
def test_moe_layer_matches_jax_f32(B, S, E, K, cf, shared):
    p, x = _params(E, shared), _x(B, S)
    ty, taux, jy, jaux = _both(p, x, top_k=K, capacity_factor=cf)
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=0)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)


def test_capacity_drops_the_same_tokens():
    """At cf 1.25 and 64 tokens over 4 experts, assignments overflow;
    the port drops the reference's: the outputs agree token by token, and
    differ from the no-drop result exactly where tokens lost an expert.
    The router leans to expert 0, which overflows its 40 slots."""
    p, x = _params(4, False, seed=3), _x(1, 64, seed=4) + 0.5
    p["router"][:, 0] += 0.2
    assert _dropped(p, x, 2, 1.25) > 0
    ty, _, jy, _ = _both(p, x, top_k=2, capacity_factor=1.25)
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=0)
    full, _, _, _ = _both(p, x, top_k=2, capacity_factor=None)
    changed = np.abs(full - ty).max(-1)[0] > 1e-6
    assert changed.any() and not changed.all()


@pytest.mark.parametrize("cf", [None, 1.25])
@pytest.mark.parametrize("B,S,E,K", [(2, 24, 4, 2), (1, 1, 8, 2)])
def test_moe_layer_matches_jax_bf16(B, S, E, K, cf):
    bf = ml_dtypes.bfloat16
    p = _params(E, True, dtype=bf)
    x = _x(B, S, dtype=bf)
    ty, taux, jy, jaux = _both(p, x, top_k=K, capacity_factor=cf)
    assert TL.moe_layer(from_numpy(p), from_numpy(x), top_k=K,
                        capacity_factor=cf)[0].dtype == torch.bfloat16
    np.testing.assert_allclose(ty, jy, atol=2e-2 * np.abs(jy).max(), rtol=0)
    np.testing.assert_allclose(taux, jaux, rtol=1e-2)


def test_ties_go_to_the_lower_expert_id():
    """A zero router gives every expert the same probability: jax.lax.top_k
    takes the lowest ids first, and so does the port (a stable descending
    sort; ``torch.topk`` leaves the order of ties unspecified)."""
    p = _params(6, False)
    p["router"] = np.zeros_like(p["router"])
    x = _x(2, 5)
    ty, taux, jy, jaux = _both(p, x, top_k=2, capacity_factor=None)
    np.testing.assert_allclose(ty, jy, atol=1e-4, rtol=0)
    want = TL.mlp({k: torch.from_numpy(p[k][0]) for k in
                   ("w_gate", "w_up", "w_down")}, torch.from_numpy(x)) * 0.5 \
        + TL.mlp({k: torch.from_numpy(p[k][1]) for k in
                  ("w_gate", "w_up", "w_down")}, torch.from_numpy(x)) * 0.5
    np.testing.assert_allclose(ty, want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)


@pytest.mark.parametrize("T,K,E,cf,want", [(1024, 4, 60, 1.25, 86),
                                           (1, 4, 60, 1.25, 1),
                                           (12, 2, 8, 1.25, 4),
                                           (100, 2, 8, None, 100)])
def test_capacity_formula(T, K, E, cf, want):
    assert TL.moe_capacity(T, K, E, cf) == want
