"""The port's training slice against the reference on the same weights
(a JAX ``init_model`` pytree carried by ``repro_torch.params``) and the
same numpy batches from a seed: ``train_loss``'s value and every
gradient leaf for each family's reduced config, ``remat``, five
``make_train_step`` steps from one carried param and optimizer state, the
data sources, the ``train`` loop (the twin of ``test_training_reduces_
loss``) and its checkpoint read back by ``repro.checkpoint``.

Tolerances, f32 throughout: the loss to 1e-4 absolute and each gradient
leaf to 1e-4 of its largest |value| (the reference's f32 attention
tolerance; measured 1.6e-6 at worst); prefill logits from a checkpoint to
5e-4 (``tests/test_torch_model_fns.py``'s decode-logit tolerance)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as JD  # noqa: E402
from repro.checkpoint import load_pytree as j_load_pytree  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import cosine_schedule as t_cosine  # noqa: E402
from repro_torch.params import (adamw_state_from_numpy, from_numpy,  # noqa: E402
                                load_npz)
from repro_torch.training import make_train_step, train  # noqa: E402

FAMILIES = ("qwen2.5-3b", "qwen2-moe-a2.7b", "falcon-mamba-7b", "zamba2-7b",
            "internvl2-76b", "whisper-medium")
LOSS_ATOL = 1e-4
GRAD_RTOL = 1e-4
LOGIT_ATOL = 5e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _weights(cfg, seed=0):
    jp = JT.init_model(cfg, jax.random.PRNGKey(seed))
    return jp, from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=16, seed=3):
    return next(iter(JD.SyntheticTokens(cfg, B, S, seed=seed)))


def _port_grads(cfg, tp, batch, **kw):
    leaves = _flat(tp)
    live = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    names = list(live)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tree.items()}
        return live[prefix]
    loss, metrics = TT.train_loss(
        cfg, rebuild(tp), {k: torch.from_numpy(v) for k, v in batch.items()},
        **kw)
    grads = torch.autograd.grad(loss, [live[n] for n in names])
    return loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_gradients_match_jax(arch):
    cfg = get_config(arch).reduced()
    jp, tp = _weights(cfg)
    batch = _batch(cfg)

    def jloss(p):
        return JT.train_loss(cfg, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tl, tm, tg = _port_grads(cfg, tp, batch)
    np.testing.assert_allclose(tl.item(), float(jl), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]),
                               atol=1e-6, rtol=0)
    if cfg.family == "moe":
        assert tm["aux"].item() > 0
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(tg)
    for name, ref in jflat.items():
        got = tg[name].numpy()
        assert got.shape == ref.shape, name
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(got - ref).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b",
                                  "whisper-medium"])
def test_remat_changes_no_value(arch):
    """``torch.utils.checkpoint`` around the layer bodies recomputes the
    same forward: the loss and every gradient equal the unwrapped run's."""
    cfg = get_config(arch).reduced()
    _, tp = _weights(cfg)
    batch = _batch(cfg)
    l0, _, g0 = _port_grads(cfg, tp, batch, remat=False)
    l1, _, g1 = _port_grads(cfg, tp, batch, remat=True)
    assert l0.item() == l1.item()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_remat_checkpoints_each_layer_body():
    """Under ``remat`` the backward recomputes the layer bodies (one more
    forward of each), and not without it."""
    cfg = get_config("qwen2.5-3b").reduced()
    _, tp = _weights(cfg)
    batch = _batch(cfg)
    calls = []
    real = TT.attn_block_full

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    TT.attn_block_full = counting
    try:
        _port_grads(cfg, tp, batch, remat=False)
        plain = len(calls)
        calls.clear()
        _port_grads(cfg, tp, batch, remat=True)
        rematted = len(calls)
    finally:
        TT.attn_block_full = real
    assert plain == cfg.num_layers and rematted == 2 * cfg.num_layers


def _leaf_diffs(port, ref, prefix=""):
    if isinstance(ref, dict):
        for k in ref:
            yield from _leaf_diffs(port[k], ref[k], f"{prefix}/{k}")
        return
    yield prefix, np.abs(port.numpy() - np.asarray(ref))


def _adam_noise(grad, lr):
    """How far one AdamW step at rate ``lr`` can move each element of a
    leaf in one package and not in the other when their gradients differ
    by up to ``GRAD_RTOL`` of the leaf's largest |value| (what
    ``test_train_loss_matches_jax`` holds them to): the step is about
    ``lr * m / sqrt(v)``, which changes by up to about twice the
    gradient's relative change, ``GRAD_RTOL * max|g| / |g|``, and by
    ``2 * lr`` where it flips sign, which takes ``|g|`` under
    ``GRAD_RTOL * max|g|`` (a zero gradient's element included)."""
    a = np.abs(grad)
    r = a / a.max() if a.max() > 0 else np.zeros_like(a)
    with np.errstate(divide="ignore"):
        return lr * np.minimum(2.0, 2 * GRAD_RTOL / r)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b"])
def test_five_train_steps_match_jax(arch):
    """Five steps of both packages' ``make_train_step`` from one carried
    state (the reference's params and ``AdamWState``), on the same
    batches.  Losses and grad norms to 1e-4.  AdamW scales each element's
    step by its own gradient's magnitude, so an element whose gradient is
    near rounding noise (the key bias's is zero in exact arithmetic: a
    bias added to every key's score cancels in the softmax) moves by up
    to the rate a step in either package.  So each element of every param
    is held to 1e-5 plus the sum over the steps of ``_adam_noise`` of the
    reference's gradient at that step: about 1e-5 where the gradient is
    large, up to twice the rates where it is noise (measured: at most 0.3
    of the limit; a 0.3% fault in one row of the update fails it)."""
    cfg = get_config(arch).reduced()
    jp, tp = _weights(cfg)
    sched = dict(base_lr=3e-3, warmup=1, total=5)
    jstep, jinit = j_make_train_step(
        cfg, optimizer=j_adamw(schedule=j_cosine(**sched)))
    tstep, _ = make_train_step(cfg, optimizer=t_adamw(
        schedule=t_cosine(**sched)))
    js = jinit(jp)
    ts = adamw_state_from_numpy(np.asarray(js.step),
                                jax.tree.map(np.asarray, js.m),
                                jax.tree.map(np.asarray, js.v))
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: JT.train_loss(cfg, p, b)[0]))
    data = JD.SyntheticTokens(cfg, 2, 16, seed=5)
    noise = {}
    for i in range(5):
        b = next(data)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        lr = t_cosine(**sched)(i + 1)
        for name, g in _flat(jax.tree.map(np.asarray, jgrad(jp, jb))).items():
            noise[name] = noise.get(name, 0.0) + _adam_noise(g, lr)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert ts.step == int(js.step) == 5
    for name, d in _leaf_diffs(tp, jax.tree.map(np.asarray, jp)):
        limit = 1e-5 + noise[name]
        assert (d <= limit).all(), (name, float((d / limit).max()))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-76b",
                                  "whisper-medium"])
def test_synthetic_tokens_match_reference(arch):
    cfg = get_config(arch).reduced()
    ref = JD.SyntheticTokens(cfg, 3, 24, seed=7)
    port = TD.SyntheticTokens(cfg, 3, 24, seed=7)
    for _ in range(3):
        a, b = next(ref), next(port)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_frame_source_matches_reference():
    cfg = get_config("qwen2.5-3b").reduced()
    ref = list(JD.FrameSource(cfg, fps=4.0, seq=16, seed=2).frames(2.0))
    port = list(TD.FrameSource(cfg, fps=4.0, seq=16, seed=2).frames(2.0))
    assert len(ref) == len(port) == 8
    for a, b in zip(ref, port):
        assert (a.t_arrival, a.frame_id) == (b.t_arrival, b.frame_id)
        np.testing.assert_array_equal(a.data, b.data)


def test_training_reduces_loss():
    """E2E: a tiny dense model learns the synthetic Markov stream."""
    cfg = get_config("qwen2.5-3b").reduced()
    hist = train(cfg, steps=30, batch=8, seq=32, lr=3e-3, log_every=0,
                 remat=False, log_fn=lambda s: None, device="cpu")
    first = np.mean(hist["loss"][:5])
    last = np.mean(hist["loss"][-5:])
    assert last < first - 0.5, (first, last)
    assert len(hist["step_time"]) == 30


def test_train_checkpoint_loads_in_reference(tmp_path):
    """The port's ``train`` checkpoint (``.npz``) read by
    ``repro.checkpoint.load_pytree`` gives the reference's prefill the
    logits the port's prefill gives on the same file."""
    cfg = get_config("qwen2.5-3b").reduced()
    path = str(tmp_path / "trained.npz")
    logs = []
    train(cfg, steps=3, batch=2, seq=16, lr=3e-3, log_every=1,
          checkpoint_path=path, checkpoint_every=2, log_fn=logs.append,
          device="cpu")
    assert len(logs) == 3 and logs[0].startswith("step     0 loss ")
    like = JT.init_model(cfg, jax.random.PRNGKey(0))
    jp = j_load_pytree(path, like=like)
    tp = load_npz(path)
    assert not np.array_equal(np.asarray(jp["embed"]),
                              np.asarray(like["embed"]))   # trained
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 12))
    jl, _ = JT.prefill(cfg, jp, {"tokens": jnp.asarray(tok, jnp.int32)},
                       max_seq=16)
    tl, _ = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(tok)},
                       max_seq=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


def test_train_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_config("qwen2.5-3b").reduced(), steps=1, batch=1, seq=8)
