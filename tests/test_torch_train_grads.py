"""The gradients the port's training step takes, against the reference's
on the same numpy inputs from a seed: the chunked flash attention's
blockwise backward (``layers._ChunkedAttention``) against ``jax.vjp`` of
``repro.models.layers.chunked_attention`` at chunks of 8 (padded tails,
the causal skip, the window's block skip, ``q_offset``, GQA, ``Sq !=
Sk``), ``chunked_cross_entropy``'s value and gradients with ignored labels
and a ragged last chunk, and the kernel routes refusing autograd (the
reference's ``pallas_call`` has no VJP either).

Tolerance: 1e-4 absolute on outputs and gradients, the reference's own
f32 attention tolerance (``tests/test_kernels.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

ATOL = 1e-4

# (B, Sq, Sk, H, KH, D, causal, window, q_offset); chunks of 8
ATTN_CASES = {
    "causal_ragged_gqa": (2, 20, 20, 4, 2, 16, True, None, 0),
    "noncausal_sq_ne_sk": (1, 12, 21, 4, 2, 16, False, None, 0),
    "window_block_skip_mqa": (1, 40, 40, 4, 1, 8, True, 12, 0),
    "q_offset": (1, 10, 26, 6, 3, 8, True, None, 16),
    "q_offset_window": (1, 10, 26, 6, 3, 8, True, 9, 16),
}


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_backward_matches_jax_vjp(case):
    B, Sq, Sk, H, KH, D, causal, window, q_offset = ATTN_CASES[case]
    if window is not None and Sq == Sk:
        # the static block skip is taken: fewer kv chunks than the keys'
        assert -(-(window + 8) // 8) + 1 < -(-Sk // 8)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KH, D)).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=8,
              kv_chunk=8)
    jout, vjp = jax.vjp(lambda a, b, c: JL.chunked_attention(a, b, c, **kw),
                        q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = TL.chunked_attention(tq, tk, tv, **kw)
    tout.backward(torch.from_numpy(dout))
    _close(tout, jout)
    for t, j in zip((tq, tk, tv), jgrads):
        assert t.grad.dtype == t.dtype
        _close(t.grad, j)


def test_attention_chunked_route_is_the_function():
    """``attention(impl="chunked")`` records the blockwise backward (not
    autograd through the forward's chunks); ``"naive"`` stays plain
    autograd, and the two agree."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 24, 4, 8)).astype(
        np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 24, 2, 8)).astype(
        np.float32)).requires_grad_()
    out = TL.attention(q, k, k, impl="chunked", q_chunk=8)
    assert type(out.grad_fn).__name__ == "_ChunkedAttentionBackward"
    g = torch.autograd.grad(out.square().sum(), (q, k))
    ref = TL.attention(q, k, k, impl="naive")
    assert type(ref.grad_fn).__name__ != "_ChunkedAttentionBackward"
    gr = torch.autograd.grad(ref.square().sum(), (q, k))
    for a, b in zip(g, gr):
        _close(a, b.numpy())


def test_chunked_cross_entropy_matches_jax():
    """Value and gradients (hidden and the tied head) with ignored labels
    and a ragged last chunk (37 rows in chunks of 16)."""
    cfg = get_config("qwen2.5-3b").reduced()
    assert cfg.tie_embeddings
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, 30:] = -1
    embed = (rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.02
             ).astype(np.float32)

    def jloss(h, e):
        return JT.chunked_cross_entropy(cfg, {"embed": e}, h,
                                        jnp.asarray(labels), chunk=16)
    jl, (jgh, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(hidden, embed)
    th = torch.from_numpy(hidden).requires_grad_()
    te = torch.from_numpy(embed).requires_grad_()
    tl = TT.chunked_cross_entropy(cfg, {"embed": te}, th,
                                  torch.from_numpy(labels), chunk=16)
    tl.backward()
    _close(tl, jl)
    _close(th.grad, jgh)
    _close(te.grad, jge)
    # every label ignored: 0 over max(count, 1)
    ignored = torch.full((2, 37), -1)
    none = TT.chunked_cross_entropy(cfg, {"embed": te.detach()},
                                    th.detach(), ignored, chunk=16)
    assert none.item() == 0.0


def _rand(*shape, requires_grad=True):
    t = torch.randn(*shape, generator=torch.Generator().manual_seed(3))
    return t.requires_grad_(requires_grad)


@pytest.mark.parametrize("impl", ["kernel", "pallas"])
def test_attention_kernel_route_refuses_autograd(impl):
    q, k = _rand(1, 8, 2, 8), _rand(1, 8, 2, 8, requires_grad=False)
    with pytest.raises(RuntimeError, match='impl="chunked"'):
        TL.attention(q, k, k, impl=impl)
    with torch.no_grad():           # a forward with nothing recorded runs
        out = TL.attention(q, k, k, impl=impl)
    _close(out, TL.attention(q, k, k, impl="chunked").detach().numpy())
    TL.attention(q.detach(), k, k, impl=impl)


@pytest.mark.parametrize("scan", ["mamba1", "mamba2"])
def test_scan_kernel_routes_refuse_autograd(scan):
    B, S, N = 1, 6, 4
    if scan == "mamba1":
        Di = 8
        args = (_rand(B, S, Di).abs(), _rand(B, S, N), _rand(B, S, N),
                _rand(B, S, Di), -_rand(Di, N).abs())
        fn = TS.mamba1_scan
    else:
        H, P = 2, 4
        args = (_rand(B, S, H).abs(), _rand(B, S, N), _rand(B, S, N),
                _rand(B, S, H, P), -_rand(H).abs())
        fn = TS.mamba2_scan
    with pytest.raises(RuntimeError, match='impl="plain"'):
        fn(*args, impl="kernel")
    y_plain, _ = fn(*args, impl="plain")
    y_plain.float().sum().backward()        # the plain route trains
    with torch.no_grad():
        y_kernel, _ = fn(*args, impl="kernel")
    _close(y_kernel, y_plain.detach().numpy())


@pytest.mark.parametrize("impl", ["kernel", "pallas"])
def test_make_train_step_refuses_kernel_attention(impl):
    cfg = get_config("qwen2.5-3b").reduced()
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, attn_impl=impl)


def test_train_loss_on_kernel_routes_raises():
    """Through the whole model: a kernel route under autograd raises (the
    reference cannot differentiate a ``pallas_call`` either)."""
    cfg = get_config("qwen2.5-3b").reduced()
    jp = JT.init_model(cfg, jax.random.PRNGKey(0))
    tp = from_numpy(jax.tree.map(np.asarray, jp))
    tp["embed"].requires_grad_()
    tok = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no backward"):
        TT.train_loss(cfg, tp, {"tokens": tok, "labels": tok},
                      attn_impl="kernel")
