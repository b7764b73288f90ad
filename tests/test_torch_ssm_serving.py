"""The port's stateful and stateless edge-cloud paths for the ssm
(falcon-mamba-7b) and hybrid (zamba2-7b) families against the JAX package
on the same weights: the unit layout, prefill + decode logits, exported
hand-off payloads in both directions, switch_b2 / switch_a / pause_resume
on both hand-off arms, split invariance, the recompute arm's conv state
for a context shorter than the conv, and the stateless ``StageRunner``.

Reduced configs: falcon-mamba-7b at 3 layers, zamba2-7b at 4 layers with
its shared attention after every 2nd (two applications)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import stateful as JS  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.stages import StageRunner as JRunner  # noqa: E402
from repro.core.stateful import make_stateful_manager as jax_manager  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import stateful as TS  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.stages import StageRunner  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       make_stateful_manager)
from repro_torch.params import from_numpy  # noqa: E402

MAX_SEQ = 32
PROMPT = 8
ATOL = 5e-4          # tests/test_decode_hotpath.py's kernel-route tolerance
FAMILIES = {"ssm": ("falcon-mamba-7b", 3), "hybrid": ("zamba2-7b", 4)}


def _cfgs(family):
    arch, layers = FAMILIES[family]
    return (dataclasses.replace(get_config(arch).reduced(),
                                num_layers=layers),
            dataclasses.replace(tget(arch).reduced(), num_layers=layers))


def _port(family, js, *, split=1, port_impl="kernel", **kw):
    """A port manager on the weights and prompt of the JAX session
    ``js``."""
    _, tcfg = _cfgs(family)
    return make_stateful_manager(
        tcfg, from_numpy(jax.tree.map(np.asarray, js.runner.params)),
        split=split, net=NetworkModel(20.0), max_seq=MAX_SEQ,
        decode_impl=port_impl, device="cpu", prompt=np.asarray(js.tokens),
        **kw)


def _pair(family, *, split=1, jax_impl="kernel", port_impl="kernel",
          **kw):
    """A JAX manager and a port manager on the same weights and prompt."""
    cfg, _ = _cfgs(family)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jm, js = jax_manager(cfg, params, split=split, net=JNet(20.0),
                         prompt_len=PROMPT, max_seq=MAX_SEQ,
                         decode_impl=jax_impl, **kw)
    return (jm, js), _port(family, js, split=split, port_impl=port_impl,
                           **kw)


def _step_both(jm, js, tm, atol=ATOL):
    """One decode step on both, fed the JAX stream's greedy token."""
    tok = np.asarray(js.next_token())
    a, _ = jm.active.process({"token": tok})
    b, _ = tm.active.process({"token": tok})
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                               rtol=1e-3)
    return tok


def _assert_same_payload(p, p_ref, atol):
    """tests/test_decode_hotpath.py's check: identical keys, dtypes,
    shapes and byte counts, values within ``atol``."""
    assert set(p) == set(p_ref)
    for k in p_ref:
        if k == HANDOFF_META_KEY:
            continue
        dt, shape, buf = p[k]
        dt0, shape0, buf0 = p_ref[k]
        assert (dt, tuple(shape), len(buf)) == (dt0, tuple(shape0),
                                                len(buf0)), k
        np.testing.assert_allclose(
            np.frombuffer(buf, dt).reshape(shape).astype(np.float64),
            np.frombuffer(buf0, dt0).reshape(shape0).astype(np.float64),
            atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_unit_layout_matches_jax(arch):
    """Units (zamba2's shared-attention applications among them), the
    units of every split and each unit's state keys, at full depth."""
    cfg, tcfg = get_config(arch), tget(arch)
    assert TS.unit_list(tcfg) == JS.unit_list(cfg)
    for split in range(-1, cfg.num_layers + 2):
        assert TS.unit_index_of_split(tcfg, split) == \
            JS.unit_index_of_split(cfg, split)
    for unit in JS.unit_list(cfg):
        assert TS._unit_state_keys(tcfg, unit) == \
            JS._unit_state_keys(cfg, unit)
    if arch == "zamba2-7b":
        assert sum(k == "app" for k, _ in TS.unit_list(tcfg)) == 13


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_jax(family):
    """The port's kernel route (its scans' plain versions on the CPU)
    against JAX's kernel route (Pallas interpret) and JAX's reference
    route, logits at 5e-4; the exported state after the steps has JAX's
    keys, dtypes and shapes, values within 5e-4."""
    (jk, jks), (tk, tks) = _pair(family)
    (jr, jrs), (tr, trs) = _pair(family, jax_impl="reference",
                                 port_impl="reference")
    for got in (tks, trs):
        for want in (jks, jrs):
            np.testing.assert_allclose(got.last_logits.numpy(),
                                       np.asarray(want.last_logits),
                                       atol=ATOL)
    for _ in range(3):
        tok = _step_both(jk, jks, tk)
        a, _ = jr.active.process({"token": tok})
        b, _ = tr.active.process({"token": tok})
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   rtol=1e-3)
    L = jks.cfg.num_layers
    p_jax, n_jax = jks.export_layers(0, L)
    p_port, n_port = tks.export_layers(0, L)
    assert n_port == n_jax
    _assert_same_payload(p_port, p_jax, ATOL)
    for m in (jk, jr, tk, tr):
        m.close()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_payloads_interchange_both_directions(family):
    (jm, js), (tm, ts) = _pair(family)
    for _ in range(2):
        _step_both(jm, js, tm)
    L = js.cfg.num_layers
    # JAX -> port: the port keeps decoding on the imported state
    payload, _ = js.export_layers(0, L)
    ts.import_layers(payload)
    for k, v in ts.cache.items():
        if not TS._is_kv(k):
            dtype, shape, buf = payload[k]
            assert torch.equal(v, torch.from_numpy(
                np.frombuffer(buf, dtype).reshape(shape).copy())), k
    _step_both(jm, js, tm)
    # port -> JAX: same envelope, same byte layout
    payload, n_port = ts.export_layers(0, L)
    assert n_port == js.export_layers(0, L)[1]
    js.import_layers(payload)
    _step_both(jm, js, tm)
    jm.close()
    tm.close()


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("force_mode", ["transfer", "recompute"])
def test_switching_on_both_arms(family, force_mode):
    """switch_b2, switch_a and pause_resume pinned to one hand-off arm:
    the same hand-off as JAX's (arm, bytes), logits within 5e-4 of JAX's;
    against an unswitched port session fed the same tokens, bit-equal
    after the transfer arm and within 5e-4 after the recompute arm."""
    (jm, js), (tm, ts) = _pair(family, split=1, standby_split=2,
                               force_mode=force_mode)
    um, _ = _port(family, js, split=1)
    for strategy, split in [(None, None), ("switch_b2", 3), ("switch_a", 2),
                            ("pause_resume", 0)]:
        if strategy is not None:
            if strategy == "switch_a":
                jm.build_standby(split)
                tm.build_standby(split)
            ja = jm.repartition(strategy, split)
            ta = tm.repartition(strategy, split)
            assert (ta.strategy, ta.old_split, ta.new_split) == \
                (ja.strategy, ja.old_split, ja.new_split)
            assert ta.handoff_mode == ja.handoff_mode == force_mode
            assert ta.handoff_bytes == ja.handoff_bytes
        for _ in range(2):
            tok = _step_both(jm, js, tm)
            got = ts.last_logits
            want, _ = um.active.process({"token": tok})
            if force_mode == "transfer" or strategy is None:
                assert torch.equal(got, want), strategy
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           atol=ATOL)
        assert ts.pos == js.pos and ts.epoch == js.epoch
    for m in (jm, tm, um):
        m.close()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_split_invariance_bit_exact(family):
    """Every split serves the same logits, bit for bit: the same kernels
    run in the same order whatever the stages' boundary."""
    _, tcfg = _cfgs(family)
    cfg, _ = _cfgs(family)
    params = from_numpy(jax.tree.map(
        np.asarray, JT.init_model(cfg, jax.random.PRNGKey(1))))
    runs = []
    for split in range(tcfg.num_layers + 1):
        mgr, s = make_stateful_manager(tcfg, params, split=split,
                                       net=NetworkModel(20.0),
                                       prompt_len=PROMPT, max_seq=MAX_SEQ,
                                       decode_impl="kernel", device="cpu")
        logits = [s.last_logits]
        for _ in range(3):
            logits.append(mgr.active.process()[0])
        runs.append(torch.stack(logits))
        mgr.close()
    for split, run in enumerate(runs[1:], 1):
        assert torch.equal(run, runs[0]), f"split {split}"


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("length", [2, 11])
def test_recompute_state_matches_jax(family, length):
    """The masked re-prefill over the whole unit range at a live length
    shorter than the conv (2 < K - 1 = 3: the conv state is zero-filled)
    and longer: state equal to JAX's recompute fn within 5e-4."""
    cfg, tcfg = _cfgs(family)
    params = JT.init_model(cfg, jax.random.PRNGKey(2))
    jr = JS.StatefulStageRunner(cfg, params, max_seq=MAX_SEQ)
    tr = TS.StatefulStageRunner(tcfg, from_numpy(jax.tree.map(
        np.asarray, params)), max_seq=MAX_SEQ, device="cpu")
    U = len(tr.units)
    x = np.zeros((1, MAX_SEQ, cfg.d_model), np.float32)
    x[:, :length] = np.random.default_rng(3).standard_normal(
        (1, length, cfg.d_model))
    want = jr.recompute_fn(0, U)(params, jnp.asarray(x), jnp.int32(length))
    got = tr.recompute_fn(0, U)(tr.params, torch.from_numpy(x), length)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=ATOL,
                                   err_msg=k)
        if k.startswith("conv") and length < 3:
            assert bool((got[k][:, :3 - length] == 0).all()), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stateless_stage_runner_matches_jax(family):
    """``StageRunner`` on the kernel routes against JAX's on its Pallas
    route: logits at 1e-4, every split bit-equal to the unsplit run."""
    cfg, tcfg = _cfgs(family)
    params = JT.init_model(cfg, jax.random.PRNGKey(4))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12))
    jr = JRunner(cfg, params, attn_impl="pallas")
    tr = StageRunner(tcfg, from_numpy(jax.tree.map(np.asarray, params)),
                     attn_impl="kernel", device="cpu")
    assert tr.num_units == jr.num_units
    want = np.asarray(jr.run_units({"tokens": tokens}, 0, jr.num_units)
                      ["logits"])
    inputs = {"tokens": torch.from_numpy(tokens)}
    mono = tr.run_units(inputs, 0, tr.num_units)["logits"]
    np.testing.assert_allclose(mono.numpy(), want, atol=1e-4)
    for split in range(tr.num_units - 1):
        mid = tr.run_units(inputs, 0, split + 1)
        out = tr.run_units(mid, split + 1, tr.num_units)["logits"]
        assert torch.equal(out, mono), f"split {split}"
        assert tr.edge_param_bytes(split) == jr.edge_param_bytes(split)
