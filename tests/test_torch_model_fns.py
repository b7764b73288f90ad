"""The port's standalone model functions (``forward_hidden``, ``prefill``,
``decode_step``, ``init_cache``, ``effective_window``) against
``repro.models.transformer``'s on the same weights (a JAX ``init_model``
pytree carried by ``repro_torch.params``) and tokens (numpy from a seed),
reduced configs of seven architectures: hidden states and prefill caches
to 1e-4, decode logits to 5e-4 (``tests/test_decode_hotpath.py:105``).

The ring: a windowed cache holds ``CL`` rows, position ``p`` at row ``p
mod CL``.  Where the prompt fits the ring or fills it a whole number of
times, the port's cache is the reference's and so are its decode steps.
Past that (``S > CL``, ``S mod CL != 0``) the reference keeps the last
``CL`` rows at rows ``0 .. CL - 1`` and its first decode step overwrites a
row inside the window; the port is held to the reference's own windowed
forward there, and the reference's gap to it is shown (ROADMAP.md,
Queue C)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

ARCHS = ("qwen2.5-3b", "starcoder2-7b", "yi-34b", "qwen2-moe-a2.7b",
         "mixtral-8x22b", "falcon-mamba-7b", "zamba2-7b")
MAX_SEQ = 32
HIDDEN_ATOL = 1e-4
LOGIT_ATOL = 5e-4
_WEIGHTS = {}


def _weights(cfg, seed=0):
    key = (cfg, seed)
    if key not in _WEIGHTS:
        jp = JT.init_model(cfg, jax.random.PRNGKey(seed))
        _WEIGHTS[key] = (jp, from_numpy(jax.tree.map(np.asarray, jp)))
    return _WEIGHTS[key]


def _jdecode(cfg):
    """The reference's ``decode_step`` compiled once per config (eager, it
    would trace its layer scan anew every step)."""
    key = ("decode", cfg)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = jax.jit(functools.partial(JT.decode_step, cfg))
    return _WEIGHTS[key]


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32), atol=atol,
                               rtol=0)


def _tree_close(t, j, atol, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _tree_close(t[k], j[k], atol, f"{path}/{k}")
        return
    assert tuple(t.shape) == tuple(np.shape(j)), path
    _close(t, j, atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch):
    cfg = get_config(arch).reduced()
    jp, tp = _weights(cfg)
    tok = _tokens(cfg, 2, 12)
    jh, jaux, jkv = JT.forward_hidden(cfg, jp, {"tokens": jnp.asarray(tok)},
                                      window=cfg.sliding_window,
                                      collect_kv=True)
    th, taux, tkv = TT.forward_hidden(cfg, tp,
                                      {"tokens": torch.from_numpy(tok)},
                                      window=cfg.sliding_window,
                                      collect_kv=True)
    _close(th, jh, HIDDEN_ATOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5,
                               atol=1e-7)
    if cfg.family == "moe":
        assert taux.item() > 0
    _tree_close(tkv, jkv, HIDDEN_ATOL)


@pytest.mark.parametrize("attn_impl", ["chunked", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, attn_impl):
    """Prefill's last logits and cache, then four decode steps fed the same
    tokens; ``attn_impl="kernel"`` routes the port's prefill attention and
    decode attention through the kernels' wrappers (their plain versions
    on the CPU)."""
    cfg = get_config(arch).reduced()
    jp, tp = _weights(cfg)
    tok = _tokens(cfg, 2, 10)
    jl, jc = JT.prefill(cfg, jp, {"tokens": jnp.asarray(tok)},
                        max_seq=MAX_SEQ)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(tok)},
                        max_seq=MAX_SEQ, attn_impl=attn_impl)
    _close(tl, jl, LOGIT_ATOL)
    _tree_close(tc, jc, HIDDEN_ATOL)
    assert tc["pos"].dtype == torch.int32 and int(tc["pos"]) == 10
    nxt = _tokens(cfg, 2, 4, seed=2)
    for i in range(4):
        jl, jc = _jdecode(cfg)(jp, jnp.asarray(nxt[:, i:i + 1]), jc)
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(nxt[:, i:i + 1]),
                                tc, attn_impl=attn_impl)
        _close(tl, jl, LOGIT_ATOL)
        assert int(tc["pos"]) == 11 + i
    _tree_close(tc, jc, HIDDEN_ATOL)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch, window):
    cfg = get_config(arch).reduced()
    jc = JT.init_cache(cfg, 3, MAX_SEQ, window=window)
    tc = TT.init_cache(cfg, 3, MAX_SEQ, window=window, device="cpu")
    _tree_close(tc, jc, 0.0)

    def leaves(t):
        return [x for k in sorted(t) for x in (
            leaves(t[k]) if isinstance(t[k], dict) else [t[k]])]
    flat = leaves(tc)
    for t, j in zip(flat, leaves(jc), strict=True):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype,
                                                             j.dtype)
    # every state tensor is its own: decode writes K and V in place
    ptrs = [t.data_ptr() for t in flat if t.numel()]
    assert len(set(ptrs)) == len(ptrs)
    bf = TT.init_cache(cfg, 1, 16, dtype=torch.bfloat16, device="cpu")
    if cfg.family in ("ssm", "hybrid"):
        assert bf["mamba"]["ssm"].dtype == torch.float32
        assert bf["mamba"]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [16, 4096, 131_072, 131_073, 500_000])
def test_effective_window_matches_jax(arch, seq):
    for cfg in (get_config(arch), get_config(arch).reduced()):
        assert TT.effective_window(cfg, seq) == JT.effective_window(cfg, seq)


def test_unported_families_raise():
    """Every family of the reference builds and runs (the frontends'
    parity is tests/test_torch_frontends.py); a family the reference does
    not know raises its ``ValueError``."""
    for arch in ("whisper-medium", "internvl2-76b"):
        cfg = get_config(arch).reduced()
        jc = JT.init_cache(cfg, 1, 8)
        _tree_close(TT.init_cache(cfg, 1, 8, device="cpu"), jc, 0.0)
        tp = TT.init_model(cfg, device="cpu")
        inputs = {"tokens": torch.zeros(1, 2).long()}
        if cfg.frontend == "audio":
            inputs["frames"] = torch.zeros(1, cfg.encoder.context_len,
                                           cfg.d_model)
        else:
            inputs["vision_embeds"] = torch.zeros(1, cfg.frontend_tokens,
                                                  cfg.d_model)
        h, _, _ = TT.forward_hidden(cfg, tp, inputs)
        assert h.shape == (1, 2 + cfg.frontend_tokens, cfg.d_model)
    bad = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              family="rnn")
    with pytest.raises(ValueError):
        JT.init_cache(bad, 1, 8)
    with pytest.raises(ValueError):
        TT.init_cache(bad, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# the ring: mixtral's windowed cache
# ---------------------------------------------------------------------------

WIN = 8
RING_STEPS = 6


def _ring_cfg():
    # reduced mixtral: no-drop routing (capacity_factor None), a window of
    # 8 rows so prompts pass it within a few tokens
    return dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                               sliding_window=WIN)


def _windowed_logits(cfg, jp, seq):
    """The reference's windowed full forward over ``seq``: the logits at
    every position, so row ``n - 1`` is its ``prefill``'s over the first
    ``n`` tokens."""
    key = ("windowed", cfg, seq.tobytes())
    if key not in _WEIGHTS:
        h, _, _ = JT.forward_hidden(cfg, jp, {"tokens": jnp.asarray(seq)},
                                    window=cfg.sliding_window)
        _WEIGHTS[key] = np.asarray(
            (h @ JT.lm_head_weights(cfg, jp)).astype(jnp.float32))
    return _WEIGHTS[key]


def _ring_run(S):
    cfg = _ring_cfg()
    jp, tp = _weights(cfg, seed=4)
    seq = _tokens(cfg, 1, 2 * WIN + 3 + RING_STEPS, seed=5)
    return cfg, jp, tp, seq, _windowed_logits(cfg, jp, seq)


@pytest.mark.parametrize("S", [5, WIN, 2 * WIN, 13, 2 * WIN + 3])
@pytest.mark.parametrize("attn_impl", ["chunked", "kernel"])
def test_ring_decode_equals_windowed_forward(S, attn_impl):
    """After a prompt of ``S`` tokens, every decode step of the port equals
    the windowed forward over the prompt and the tokens decoded so far, as
    the ring wraps; where ``S <= CL`` or ``S mod CL == 0`` it also equals
    the reference's ``decode_step`` after its ``prefill``."""
    cfg, jp, tp, seq, want = _ring_run(S)
    tl, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(seq[:, :S])},
                        max_seq=MAX_SEQ, attn_impl=attn_impl)
    assert tc["k"].shape[3] == WIN
    _close(tl, want[:, S - 1], LOGIT_ATOL)
    reference_layout = S <= WIN or S % WIN == 0
    if reference_layout:
        _, jc = JT.prefill(cfg, jp, {"tokens": jnp.asarray(seq[:, :S])},
                           max_seq=MAX_SEQ)
    for i in range(RING_STEPS):
        n = S + i
        tl, tc = TT.decode_step(cfg, tp, torch.from_numpy(seq[:, n:n + 1]),
                                tc, attn_impl=attn_impl)
        _close(tl, want[:, n], LOGIT_ATOL)
        if reference_layout:
            jl, jc = _jdecode(cfg)(jp, jnp.asarray(seq[:, n:n + 1]),
                                    jc)
            _close(tl, jl, LOGIT_ATOL)


@pytest.mark.parametrize("S", [13, 2 * WIN + 3])
def test_reference_ring_misplaces_a_long_prompt(S):
    """The reference's own gap where ``S > CL`` and ``S mod CL != 0``: its
    first ``decode_step`` after ``prefill`` differs from its windowed
    forward over ``S + 1`` tokens by far more than the decode tolerance
    (0.29 at ``S`` 13 on another set of weights), and the port's
    does not."""
    cfg, jp, tp, seq, want = _ring_run(S)
    _, jc = JT.prefill(cfg, jp, {"tokens": jnp.asarray(seq[:, :S])},
                       max_seq=MAX_SEQ)
    jl, _ = _jdecode(cfg)(jp, jnp.asarray(seq[:, S:S + 1]), jc)
    gap = np.abs(np.asarray(jl) - want[:, S]).max()
    assert gap > 100 * LOGIT_ATOL, gap
    _, tc = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(seq[:, :S])},
                       max_seq=MAX_SEQ)
    tl, _ = TT.decode_step(cfg, tp, torch.from_numpy(seq[:, S:S + 1]), tc)
    _close(tl, want[:, S], LOGIT_ATOL)


def test_ring_rows_places_each_position_at_its_slot():
    a = torch.arange(13, dtype=torch.float32).reshape(1, 1, 13, 1, 1)
    ring = TT.ring_rows(a, 8)[0, 0, 0, :, 0]
    assert ring.tolist() == [8, 9, 10, 11, 12, 5, 6, 7]
    assert TT.ring_rows(a[:, :, :5], 8)[0, 0, 0, :, 0].tolist() == \
        [0, 1, 2, 3, 4, 0, 0, 0]
    assert TT.ring_rows(a[:, :, :8], 8)[0, 0, 0, :, 0].tolist() == \
        list(range(8))
