"""Port of the dense layer and transformer math: each ported function of
repro_torch.models against its repro.models counterpart on the same inputs
(made with numpy from a seed), atol 1e-5 in f32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

ATOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=1e-5)


def test_rms_norm():
    x, s = _rand(2, 5, 64), _rand(64, seed=1)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_tables_and_apply(theta):
    pos = np.arange(7, dtype=np.int32) * 37
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 32, theta)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, theta)
    _close(tc, jc)
    _close(ts, js)
    x = _rand(2, 7, 3, 32)
    _close(TL.apply_rope(torch.from_numpy(x), tc, ts),
           JL.apply_rope(jnp.asarray(x), jc, js))
    # per-row (B, S, D/2) tables
    bpos = np.stack([pos, pos + 5])
    tc, ts = TL.rope_cos_sin(torch.from_numpy(bpos), 32, theta)
    jc, js = JL.rope_cos_sin(jnp.asarray(bpos), 32, theta)
    _close(TL.apply_rope(torch.from_numpy(x), tc, ts),
           JL.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, None, 0), (False, None, 0), (True, 5, 0),
                          (True, None, 4)])
def test_naive_attention(causal, window, q_offset):
    q, k, v = _rand(2, 9, 4, 16), _rand(2, 13, 2, 16, seed=1), \
        _rand(2, 13, 2, 16, seed=2)
    args = dict(causal=causal, window=window, q_offset=q_offset)
    _close(TL.naive_attention(*map(torch.from_numpy, (q, k, v)), **args),
           JL.naive_attention(*map(jnp.asarray, (q, k, v)), **args))


@pytest.mark.parametrize("Sq,Sk,qc,kc,window,q_offset", [
    (24, 24, 1024, 1024, None, 0),       # one chunk, the prefill default
    (40, 40, 16, 16, None, 0),           # ragged chunks, causal skip
    (40, 40, 8, 8, 12, 0),               # sliding-window block skip
    (10, 30, 4, 8, None, 20),            # offset queries
])
def test_chunked_attention(Sq, Sk, qc, kc, window, q_offset):
    q, k, v = _rand(1, Sq, 4, 16), _rand(1, Sk, 2, 16, seed=1), \
        _rand(1, Sk, 2, 16, seed=2)
    args = dict(causal=True, window=window, q_offset=q_offset, q_chunk=qc,
                kv_chunk=kc)
    _close(TL.chunked_attention(*map(torch.from_numpy, (q, k, v)), **args),
           JL.chunked_attention(*map(jnp.asarray, (q, k, v)), **args))


@pytest.mark.parametrize("pos", [9, 32, [3, 17], [0, 5]])
def test_decode_attention(pos):
    q, k, v = _rand(2, 1, 4, 16), _rand(2, 2, 32, 16, seed=1), \
        _rand(2, 2, 32, 16, seed=2)
    tpos = torch.tensor(pos, dtype=torch.int32)
    jpos = jnp.asarray(pos, jnp.int32)
    _close(TL.decode_attention(*map(torch.from_numpy, (q, k, v)), pos=tpos),
           JL.decode_attention(*map(jnp.asarray, (q, k, v)), pos=jpos))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    x = _rand(2, 3, 32)
    p = {"w_gate": _rand(32, 64, seed=1, scale=0.1),
         "w_up": _rand(32, 64, seed=2, scale=0.1),
         "w_down": _rand(64, 32, seed=3, scale=0.1)}
    _close(TL.mlp(from_numpy(p), torch.from_numpy(x), gated=gated),
           JL.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), gated=gated))


def test_attention_dispatch():
    q, k, v = _rand(1, 6, 4, 8), _rand(1, 6, 2, 8, seed=1), \
        _rand(1, 6, 2, 8, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for impl in ("naive", "chunked"):
        _close(TL.attention(tq, tk, tv, impl=impl),
               JL.attention(*map(jnp.asarray, (q, k, v)), impl=impl))
    with pytest.raises(NotImplementedError):
        TL.attention(tq, tk, tv, impl="kernel")
    with pytest.raises(ValueError):
        TL.attention(tq, tk, tv, impl="nope")


def _cfgs():
    base = get_config("qwen2.5-3b").reduced()
    tbase = tget("qwen2.5-3b").reduced()
    return [(base, tbase),
            (dataclasses.replace(base, num_kv_heads=2),
             dataclasses.replace(tbase, num_kv_heads=2))]


@pytest.mark.parametrize("which", [0, 1], ids=["mqa", "gqa"])
def test_attn_block_full_and_head(which):
    cfg, tcfg = _cfgs()[which]
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy(jax.tree.map(np.asarray, params))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    tlp = {"ln1": {"scale": tparams["layers"]["ln1"]["scale"][0]},
           "ln2": {"scale": tparams["layers"]["ln2"]["scale"][0]},
           "attn": {k: v[0] for k, v in tparams["layers"]["attn"].items()},
           "mlp": {k: v[0] for k, v in tparams["layers"]["mlp"].items()}}
    x = _rand(1, 12, cfg.d_model, seed=5)
    S = x.shape[1]
    jrope = JL.rope_cos_sin(jnp.arange(S), cfg.head_dim, cfg.rope_theta)
    trope = TL.rope_cos_sin(torch.arange(S), cfg.head_dim, cfg.rope_theta)
    jx, (jk, jv), _ = JT.attn_block_full(cfg, lp, jnp.asarray(x), jrope,
                                         impl="chunked")
    tx, (tk, tv), _ = TT.attn_block_full(tcfg, tlp, torch.from_numpy(x),
                                         trope, impl="chunked")
    _close(tx, jx)
    _close(tk, jk)
    _close(tv, jv)
    tq = TT._project_qkv(tcfg, tlp["attn"], torch.from_numpy(x))
    jq = JT._project_qkv(cfg, lp["attn"], jnp.asarray(x))
    for a, b in zip(tq, jq):
        _close(a, b)
    h = _rand(1, 3, cfg.d_model, seed=6)
    _close(torch.from_numpy(h) @ TT.lm_head_weights(tcfg, tparams),
           jnp.asarray(h) @ JT.lm_head_weights(cfg, params), atol=1e-5)


def test_init_model_matches_reference_layout():
    """Same keys, shapes, dtypes and scale as the reference's init."""
    cfg = get_config("qwen2.5-3b").reduced()
    tcfg = tget("qwen2.5-3b").reduced()
    jp = jax.tree.map(np.asarray, JT.init_model(cfg, jax.random.PRNGKey(0)))
    tp = TT.init_model(tcfg, device="cpu", seed=0)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            tflat[path] = t
    walk(tp, ())
    assert len(jflat) == len(tflat)
    for path, arr in jflat:
        key = tuple(p.key for p in path)
        t = tflat[key]
        assert tuple(t.shape) == arr.shape, key
        assert t.dtype == torch.float32
        if key[-1] in ("scale",):
            assert torch.equal(t, torch.ones_like(t))
        elif key[-1] in ("bq", "bk", "bv"):
            assert torch.count_nonzero(t) == 0
        else:
            assert abs(float(t.std()) - 0.02) < 0.002, key


def test_init_model_is_seeded_and_takes_a_generator():
    cfg = tget("qwen2.5-3b").reduced()
    a = TT.init_model(cfg, device="cpu", seed=3)
    b = TT.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    c = TT.init_model(cfg, device="cpu", seed=4, dtype=torch.bfloat16)
    assert c["embed"].dtype == torch.bfloat16
    assert not torch.equal(a["embed"], c["embed"].float())
