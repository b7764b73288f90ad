"""The port's two frontend families against the JAX package on the same
weights (a JAX ``init_model`` pytree carried by ``repro_torch.params``)
and the same seeded numpy inputs: whisper-medium (``audio``: a
bidirectional encoder over stub frame embeddings, decoder layers with
cross attention, LayerNorms, sinusoidal positions) and internvl2-76b
(``vlm``: stub patch embeddings projected and prepended to the text),
both reduced, in f32.

* layers: ``layer_norm``, ``sinusoidal_positions``, ``sinusoidal_at``
  (1e-6);
* model functions: ``encode_audio``, ``cross_block_full``,
  ``forward_hidden``, ``prefill`` and its every cache entry (1e-4), and
  ``decode_step`` after ``prefill`` (logits 5e-4,
  ``tests/test_decode_hotpath.py:105``; the reference's ``decode_step``
  jitted); the twin of
  ``tests/test_arch_smoke.py::test_decode_matches_prefill``;
* the stateless path: ``StageRunner`` at every split against the
  monolithic forward and the reference's runner, ``stage_out_avals``
  against a run, ``boundary_bytes`` and ``EdgeCloudPipeline``'s priced
  link against the reference's (which prices a vlm boundary on its text
  rows only: ROADMAP.md, Queue C), the twin of
  ``tests/test_pipeline_switching.py::test_pipeline_equals_monolithic_other_families``;
* the stateful path: internvl2 (text tokens only, as the reference serves
  it) through a ``DecodeSession`` pipeline and a slot pool, against the
  reference's; whisper refused with the reference's ``ValueError``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.pipeline import EdgeCloudPipeline as JPipeline  # noqa: E402
from repro.core.stages import StageRunner as JRunner  # noqa: E402
from repro.core.stateful import make_stateful_manager as jax_manager  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.sessions import \
    make_session_manager as jax_session_manager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pipeline import EdgeCloudPipeline  # noqa: E402
from repro_torch.core.stages import StageRunner, abstractify  # noqa: E402
from repro_torch.core.stateful import (make_stateful_manager,  # noqa: E402
                                       unit_list)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import make_session_manager  # noqa: E402

ARCHS = ("whisper-medium", "internvl2-76b")
MAX_SEQ = 32
HIDDEN_ATOL = 1e-4
LOGIT_ATOL = 5e-4                # tests/test_decode_hotpath.py:105
_CACHE = {}


def _cfgs(arch):
    return get_config(arch).reduced(), tget(arch).reduced()


def _weights(arch):
    """The reference's init, its norm scales and biases (ones and zeros
    there) and QKV biases moved off their initial values, so that every
    weight tells."""
    if arch not in _CACHE:
        cfg, _ = _cfgs(arch)
        rng = np.random.default_rng(7)

        def perturb(path, a):
            a = np.asarray(a)
            name = getattr(path[-1], "key", "")
            if name in ("scale", "bias", "bq", "bk", "bv"):
                a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
            return a
        npp = jax.tree_util.tree_map_with_path(
            perturb, JT.init_model(cfg, jax.random.PRNGKey(0)))
        _CACHE[arch] = (jax.tree.map(jnp.asarray, npp), from_numpy(npp))
    return _CACHE[arch]


def _jdecode(cfg):
    """The reference's ``decode_step`` compiled once per config (eager, it
    would trace its layer scan anew every step)."""
    key = ("decode", cfg)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(functools.partial(JT.decode_step, cfg))
    return _CACHE[key]


def _inputs(cfg, B, S, seed=1):
    """Seeded numpy inputs: S text tokens, and the frontend's stub
    embeddings (whisper's ``context_len`` frames, internvl2's
    ``frontend_tokens`` patches)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.context_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _j(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _t(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,d", [(16, 256), (448, 1024), (1500, 1024)])
def test_sinusoids_match_jax(S, d):
    _close(TL.sinusoidal_positions(S, d), JL.sinusoidal_positions(S, d),
           1e-6)
    pos = np.array([0, 1, 7, S - 1], np.int32)
    got = TL.sinusoidal_at(torch.from_numpy(pos), d)
    assert got.shape == (4, d) and got.dtype == torch.float32
    _close(got, JL.sinusoidal_at(jnp.asarray(pos), d), 1e-6)
    # a 0-d position: whisper's decode step
    _close(TL.sinusoidal_at(torch.tensor(S - 1).reshape(1), d),
           JL.sinusoidal_at(jnp.asarray([S - 1]), d), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, 5, 64), (64,), (64,)))
    x = x * 3 + 1
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = JL.layer_norm(*(jnp.asarray(a, jd) for a in (x, scale, bias)),
                         1e-5)
    got = TL.layer_norm(*(torch.from_numpy(a).to(td)
                          for a in (x, scale, bias)), 1e-5)
    assert got.dtype == td
    # bf16: the same f32 statistics, then the same roundings
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

def test_configs_match_the_reference():
    """The copies keep the reference's values, and ``reduced()`` (an
    encoder of 2 layers over 16 frames, 8 frontend tokens) field for
    field."""
    for arch in ARCHS:
        for cfg, tcfg in ((get_config(arch), tget(arch)), _cfgs(arch)):
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    cfg, _ = _cfgs("whisper-medium")
    assert (cfg.encoder.num_layers, cfg.encoder.context_len) == (2, 16)
    assert _cfgs("internvl2-76b")[1].frontend_tokens == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_has_the_reference_structure(arch):
    cfg, tcfg = _cfgs(arch)
    jp, _ = _weights(arch)
    tp = TT.init_model(tcfg, device="cpu")

    def walk(t, j, path=""):
        if isinstance(j, dict):
            assert set(t) == set(j), path
            for k in j:
                walk(t[k], j[k], f"{path}/{k}")
            return
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    walk(tp, jp)


@pytest.mark.parametrize("attn_impl", ["chunked", "kernel"])
def test_encode_audio_and_cross_block_match_jax(attn_impl):
    cfg, tcfg = _cfgs("whisper-medium")
    jp, tp = _weights("whisper-medium")
    inp = _inputs(cfg, 2, 6)
    jenc = JT.encode_audio(cfg, jp, jnp.asarray(inp["frames"]))
    tenc = TT.encode_audio(tcfg, tp, torch.from_numpy(inp["frames"]),
                           attn_impl=attn_impl)
    assert tenc.shape == (2, cfg.encoder.context_len, cfg.d_model)
    _close(tenc, jenc, HIDDEN_ATOL)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = TT.layer_params(tp, 1)
    x = np.random.default_rng(3).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    jkv = JT._enc_cross_kv(cfg, jlp, jenc)
    tkv = TT._enc_cross_kv(tcfg, tlp, tenc)
    for a, b in zip(tkv, jkv):
        _close(a, b, HIDDEN_ATOL)
    want = JT.cross_block_full(cfg, jlp, jnp.asarray(x), jkv,
                               impl="chunked")
    got = TT.cross_block_full(tcfg, tlp, torch.from_numpy(x), tkv,
                              impl=attn_impl)
    _close(got, want, HIDDEN_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch):
    cfg, tcfg = _cfgs(arch)
    jp, tp = _weights(arch)
    inp = _inputs(cfg, 2, 10)
    jh, _, jkv = JT.forward_hidden(cfg, jp, _j(inp), collect_kv=True)
    th, taux, tkv = TT.forward_hidden(tcfg, tp, _t(inp), collect_kv=True)
    rows = 10 + cfg.frontend_tokens
    assert th.shape == (2, rows, cfg.d_model) and float(taux) == 0.0
    _close(th, jh, HIDDEN_ATOL)
    _tree_close(tkv, jkv, HIDDEN_ATOL)
    want = {"audio": {"k", "v", "ck", "cv"}, "vlm": {"k", "v"}}[cfg.family]
    assert set(tkv) == want


@pytest.mark.parametrize("attn_impl", ["chunked", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, attn_impl):
    """Prefill's last logits and every cache entry, then four decode steps
    fed the same tokens; ``attn_impl="kernel"`` routes the port's prefill
    and self-attention decode through the kernels' wrappers (their plain
    versions on the CPU)."""
    cfg, tcfg = _cfgs(arch)
    jp, tp = _weights(arch)
    inp = _inputs(cfg, 2, 10)
    jl, jc = JT.prefill(cfg, jp, _j(inp), max_seq=MAX_SEQ)
    tl, tc = TT.prefill(tcfg, tp, _t(inp), max_seq=MAX_SEQ,
                        attn_impl=attn_impl)
    _close(tl, jl, HIDDEN_ATOL)
    _tree_close(tc, jc, HIDDEN_ATOL)
    S = 10 + cfg.frontend_tokens            # vlm's pos counts its patches
    assert tc["pos"].dtype == torch.int32 and int(tc["pos"]) == S
    nxt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                            (2, 4)).astype(np.int32)
    for i in range(4):
        jl, jc = _jdecode(cfg)(jp, jnp.asarray(nxt[:, i:i + 1]), jc)
        tl, tc = TT.decode_step(tcfg, tp, torch.from_numpy(nxt[:, i:i + 1]),
                                tc, attn_impl=attn_impl)
        _close(tl, jl, LOGIT_ATOL)
        assert int(tc["pos"]) == S + 1 + i
    _tree_close(tc, jc, HIDDEN_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    cfg, tcfg = _cfgs(arch)
    jc = JT.init_cache(cfg, 3, MAX_SEQ)
    tc = TT.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    _tree_close(tc, jc, 0.0)
    ptrs = [t.data_ptr() for t in tc.values() if t.numel() > 1]
    assert len(set(ptrs)) == len(ptrs)       # decode writes in place


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The twin of tests/test_arch_smoke.py::test_decode_matches_prefill:
    the last text token decoded against a prefill of the shorter prompt
    gives the full prefill's logits (2e-3), at ``pos`` = every row."""
    cfg, tcfg = _cfgs(arch)
    _, tp = _weights(arch)
    inp = _t(_inputs(cfg, 2, 8, seed=4))
    full, _ = TT.prefill(tcfg, tp, inp, max_seq=MAX_SEQ)
    short = dict(inp, tokens=inp["tokens"][:, :-1])
    _, cache = TT.prefill(tcfg, tp, short, max_seq=MAX_SEQ)
    dec, cache = TT.decode_step(tcfg, tp, inp["tokens"][:, -1:], cache)
    assert (full - dec).abs().max().item() < 2e-3
    assert int(cache["pos"]) == 8 + cfg.frontend_tokens


# ---------------------------------------------------------------------------
# the stateless path
# ---------------------------------------------------------------------------

def _runners(arch):
    cfg, tcfg = _cfgs(arch)
    jp, tp = _weights(arch)
    return (JRunner(cfg, jp),
            StageRunner(tcfg, tp, attn_impl="kernel", device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_equals_monolithic(arch):
    """The twin of tests/test_pipeline_switching.py::
    test_pipeline_equals_monolithic_other_families (1e-3 at splits 0, mid
    and last; the port's splits are bit-equal), and the port's logits
    against the reference's runner."""
    jr, tr = _runners(arch)
    inp = _inputs(jr.cfg, 1, 12)
    want = jr.run_units(_j(inp), 0, jr.num_units)["logits"]
    mono = tr.run_units(_t(inp), 0, tr.num_units)["logits"]
    assert mono.shape == (1, 12 + jr.cfg.frontend_tokens, jr.cfg.vocab_size)
    _close(mono, want, HIDDEN_ATOL)
    for split in [0, tr.num_units // 2, tr.num_units - 2]:
        mid = tr.run_units(_t(inp), 0, split + 1)
        assert set(mid) == ({"h", "enc"} if jr.cfg.family == "audio"
                            else {"h"})
        out = tr.run_units(mid, split + 1, tr.num_units)["logits"]
        assert (out - mono).abs().max().item() < 1e-3, split
        assert torch.equal(out, mono), split


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_out_avals_match_a_run(arch):
    """The specs worked out by hand equal the shapes, dtypes and keys a
    run gives, for the edge stage and the cloud stage of every split."""
    _, tr = _runners(arch)
    inp = _t(_inputs(tr.cfg, 2, 5))
    N = tr.num_units
    for split in range(N - 1):
        mid = tr.run_units(inp, 0, split + 1)
        assert tr.stage_out_avals(0, split + 1, tr.params, inp) == \
            abstractify(mid), split
        spec = tr.stage_out_avals(0, split + 1, tr.params, abstractify(inp))
        assert tr.stage_out_avals(split + 1, N, tr.params, spec) == \
            abstractify(tr.run_units(mid, split + 1, N)), split
    assert tr.stage_out_avals(0, N, tr.params, inp) == \
        abstractify(tr.run_units(inp, 0, N))


@pytest.mark.parametrize("arch", ARCHS)
def test_boundary_bytes_match_jax(arch):
    jr, tr = _runners(arch)
    for split in range(tr.num_units - 1):
        for batch, seq in ((1, 12), (2, 448)):
            assert tr.boundary_bytes(split, batch, seq) == \
                jr.boundary_bytes(split, batch, seq)
    d = tr.cfg.d_model
    enc = tr.cfg.encoder.context_len * d * 4 if tr.cfg.encoder else 0
    assert tr.boundary_bytes(1, 1, 12) == 12 * d * 4 + enc


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_prices_the_link_as_the_reference(arch):
    """One request through both packages' ``EdgeCloudPipeline`` at a mid
    split: the same logits, and the same priced link.  For internvl2 that
    price counts the text rows only, while the hidden that crosses has
    the patches' rows too: the reference's pricing, kept at parity
    (ROADMAP.md, Queue C)."""
    jr, tr = _runners(arch)
    inp = _inputs(jr.cfg, 1, 12)
    net = 20.0
    jpipe = JPipeline(jr, 1, JNet(net))
    jpipe.build(_j(inp), cold=False)
    tpipe = EdgeCloudPipeline(tr, 1, NetworkModel(net))
    tpipe.build(_t(inp), cold=False)
    jl, jt = jpipe.process(_j(inp))
    tl, tt = tpipe.process(_t(inp))
    _close(tl, jl, HIDDEN_ATOL)
    assert tt.t_transfer == jt.t_transfer
    d = jr.cfg.d_model
    rows = tr.run_units(_t(inp), 0, 2)["h"].shape[1]
    priced = NetworkModel(net).transfer_time(jr.boundary_bytes(1, 1, 12))
    assert jt.t_transfer == priced
    if jr.cfg.frontend == "vision":
        assert rows == 12 + jr.cfg.frontend_tokens
        assert priced < NetworkModel(net).transfer_time(rows * d * 4)


def test_frontend_inputs_reach_the_card_in_the_models_dtype():
    """On a bf16 model the frames and patch embeddings are given in bf16
    (the encoder takes its dtype from the frames): the boundary specs
    follow them."""
    for arch in ARCHS:
        tcfg = tget(arch).reduced()
        tp = TT.init_model(tcfg, dtype=torch.bfloat16, device="cpu")
        tr = StageRunner(tcfg, tp, attn_impl="kernel", device="cpu")
        inp = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
               for k, v in _t(_inputs(tcfg, 1, 4)).items()}
        mid = tr.run_units(inp, 0, 2)
        assert all(t.dtype == torch.bfloat16 for t in mid.values())
        assert tr.stage_out_avals(0, 2, tr.params, inp) == abstractify(mid)
        out = tr.run_units(mid, 2, tr.num_units)["logits"]
        assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the stateful path
# ---------------------------------------------------------------------------

PROMPT = 8


def test_stateful_path_refuses_audio_as_the_reference():
    cfg, tcfg = _cfgs("whisper-medium")
    from repro.core.stateful import unit_list as jax_unit_list
    with pytest.raises(ValueError, match="unsupported"):
        jax_unit_list(cfg)
    with pytest.raises(ValueError, match="unsupported"):
        unit_list(tcfg)
    with pytest.raises(ValueError, match="unsupported"):
        make_stateful_manager(tcfg, _weights("whisper-medium")[1], split=1,
                              net=NetworkModel(20.0), device="cpu")


@pytest.mark.parametrize("force_mode", ["transfer", "recompute"])
def test_vlm_stateful_stream_matches_jax(force_mode):
    """internvl2 served statefully by both packages (text tokens only):
    prefill, decode steps, and a switch under each strategy, each step's
    logits within 5e-5 of the reference's."""
    cfg, tcfg = _cfgs("internvl2-76b")
    jp, tp = _weights("internvl2-76b")
    jm, js = jax_manager(cfg, jp, split=1, net=JNet(20.0),
                         prompt_len=PROMPT, max_seq=MAX_SEQ,
                         standby_split=2, force_mode=force_mode)
    tm, ts = make_stateful_manager(
        tcfg, tp, split=1, net=NetworkModel(20.0), max_seq=MAX_SEQ,
        standby_split=2, force_mode=force_mode, device="cpu",
        prompt=np.asarray(js.tokens))
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), atol=5e-5)
    assert unit_list(tcfg) == [("layer", i) for i in range(cfg.num_layers)]
    for strategy, split in [(None, None), ("switch_a", 2), ("switch_b2", 0),
                            ("pause_resume", 1)]:
        if strategy is not None:
            ja = jm.repartition(strategy, split)
            ta = tm.repartition(strategy, split)
            assert (ta.handoff_mode, ta.handoff_bytes) == \
                (ja.handoff_mode, ja.handoff_bytes)
        for _ in range(2):
            tok = np.asarray(js.next_token())
            a, _ = jm.active.process({"token": tok})
            b, _ = tm.active.process({"token": tok})
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5,
                                       rtol=1e-3)
        assert ts.pos == js.pos
    jm.close()
    tm.close()


def test_vlm_slot_pool_matches_jax():
    """Ragged admissions into both packages' internvl2 slot pools (the
    reference's refuses only the MoE), decode steps fed the reference's
    greedy tokens, and a transfer switch: per-slot logits within 5e-4."""
    cfg, tcfg = _cfgs("internvl2-76b")
    jp, tp = _weights("internvl2-76b")
    kw = dict(split=1, num_slots=3, max_seq=MAX_SEQ, force_mode="transfer")
    jm, jsm = jax_session_manager(cfg, jp, net=JNet(1000.0), **kw)
    tm, tsm = make_session_manager(tcfg, tp, net=NetworkModel(1000.0),
                                   device="cpu", **kw)
    rng = np.random.default_rng(5)
    for i, n in enumerate((7, 3, 12)):
        p = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        assert tsm.admit(p, sid=f"s{i}") == jsm.admit(p, sid=f"s{i}")

    def step_and_check():
        tok = np.asarray(jsm.next_token())
        jm.active.process({"token": tok})
        tm.active.process({"token": tok})
        for sid in jsm.session_ids():
            np.testing.assert_allclose(tsm.logits_for(sid).numpy(),
                                       jsm.logits_for(sid), atol=LOGIT_ATOL,
                                       err_msg=sid)
    for _ in range(2):
        step_and_check()
    jr, tr = jm.repartition("switch_b2", 2), tm.repartition("switch_b2", 2)
    assert (tr.handoff_mode, tr.handoff_bytes) == \
        (jr.handoff_mode, jr.handoff_bytes)
    for _ in range(2):
        step_and_check()
    jm.close()
    tm.close()
