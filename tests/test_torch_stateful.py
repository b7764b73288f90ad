"""The port's stateful edge-cloud decode path against the JAX package on
the same weights: prefill + decode logits through a mid split, the same
stream under switch_a / switch_b2 / pause_resume with both hand-off arms,
hand-off payloads crossing between the packages in both directions, the
paper's downtime ordering, and the CUDA-by-default entry points."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.stateful import make_stateful_manager as jax_manager  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pool import PipelineKey, PipelinePool  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       HandoffCorrupted, StatefulStageRunner,
                                       make_stateful_manager,
                                       payload_checksum, unit_list)
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

MAX_SEQ = 32
PROMPT = 8
CASES = {"dense": {}, "dense_gqa": {"num_kv_heads": 2}}


def _cfgs(name, num_layers=3):
    kw = dict(CASES[name], num_layers=num_layers)
    return (dataclasses.replace(get_config("qwen2.5-3b").reduced(), **kw),
            dataclasses.replace(tget("qwen2.5-3b").reduced(), **kw))


def _pair(name="dense", *, split=1, jax_impl="reference",
          port_impl="reference", num_layers=3, **kw):
    """A JAX manager and a port manager on the same weights and prompt."""
    cfg, tcfg = _cfgs(name, num_layers)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jm, js = jax_manager(cfg, params, split=split, net=JNet(20.0),
                         prompt_len=PROMPT, max_seq=MAX_SEQ,
                         decode_impl=jax_impl, **kw)
    tm, ts = make_stateful_manager(
        tcfg, from_numpy(jax.tree.map(np.asarray, params)), split=split,
        net=NetworkModel(20.0), max_seq=MAX_SEQ, decode_impl=port_impl,
        device="cpu", prompt=np.asarray(js.tokens), **kw)
    return (jm, js), (tm, ts)


def _step_both(jm, js, tm, atol):
    """One decode step on both, fed the JAX stream's greedy token."""
    tok = np.asarray(js.next_token())
    a, _ = jm.active.process({"token": tok})
    b, _ = tm.active.process({"token": tok})
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                               rtol=1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_jax(name):
    """Port kernel route (its plain version on the CPU) against JAX's
    reference route at 5e-5 and JAX's Pallas route at 5e-4; the port's
    reference route against JAX's reference at 5e-5."""
    (jr, jrs), (tk, tks) = _pair(name, port_impl="kernel")
    (jk, jks), (tr, trs) = _pair(name, jax_impl="kernel")
    for want in (jrs, jks):
        for got in (tks, trs):
            np.testing.assert_allclose(got.last_logits.numpy(),
                                       np.asarray(want.last_logits),
                                       atol=5e-5)
    for _ in range(8):
        tok = np.asarray(jrs.next_token())
        ref, _ = jr.active.process({"token": tok})
        kern, _ = jk.active.process({"token": tok})
        port_k, _ = tk.active.process({"token": tok})
        port_r, _ = tr.active.process({"token": tok})
        np.testing.assert_allclose(port_k.numpy(), np.asarray(ref),
                                   atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(port_r.numpy(), np.asarray(ref),
                                   atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(port_k.numpy(), np.asarray(kern),
                                   atol=5e-4, rtol=1e-3)
    for m in (jr, jk, tk, tr):
        m.close()


@pytest.mark.parametrize("force_mode", ["transfer", "recompute"])
def test_switching_stream_matches_jax(force_mode):
    (jm, js), (tm, ts) = _pair(split=1, standby_split=2,
                               force_mode=force_mode)
    for strategy, split in [(None, None), ("switch_a", 2), ("switch_b2", 0),
                            ("pause_resume", 1)]:
        if strategy is not None:
            ja = jm.repartition(strategy, split)
            ta = tm.repartition(strategy, split)
            assert (ta.strategy, ta.old_split, ta.new_split) == \
                (ja.strategy, ja.old_split, ja.new_split)
            assert ta.handoff_mode == ja.handoff_mode == force_mode
            assert ta.handoff_bytes == ja.handoff_bytes
            assert ta.full_outage == ja.full_outage
        for _ in range(2):
            _step_both(jm, js, tm, atol=5e-5)
        assert ts.pos == js.pos and ts.epoch == js.epoch
    jm.close()
    tm.close()


def test_payloads_interchange_both_directions():
    (jm, js), (tm, ts) = _pair(split=1)
    for _ in range(3):
        _step_both(jm, js, tm, atol=5e-5)
    L = js.cfg.num_layers
    # JAX -> port: the port keeps decoding on the imported KV
    payload, nbytes = js.export_layers(0, L)
    assert payload[HANDOFF_META_KEY][2] == payload_checksum(payload)
    ts.import_layers(payload)
    _step_both(jm, js, tm, atol=5e-5)
    # port -> JAX: same envelope, same bytes layout
    payload, n_port = ts.export_layers(0, L)
    assert n_port == js.export_layers(0, L)[1]
    js.import_layers(payload)
    _step_both(jm, js, tm, atol=5e-5)
    jm.close()
    tm.close()


def own_downtime(rep) -> float:
    """A switch's downtime less its state hand-off: what the strategy
    itself blocks the stream for (switch_a a pointer swap, switch_b2 a
    build, pause_resume a cold build that reloads the weights)."""
    return rep.downtime - rep.t_handoff


def test_downtime_ordering():
    """tests/test_pipeline_switching.py's ordering on the port's stateful
    pool: t(A) < t(B2) < t(pause_resume), and only the baseline is a full
    outage that reloads weights from storage.

    Every switch here also re-prefills the moved layers (the recompute arm,
    forced), and the switches move different numbers of layers, so the
    ordering is asserted on each strategy's own part of the downtime.  The
    walls are taken on a CPU shared with other test workers: each is read
    as the minimum over three rounds of the same switches."""
    _, tcfg = _cfgs("dense")
    mgr, _ = make_stateful_manager(tcfg, split=1, net=NetworkModel(20.0),
                                   prompt_len=PROMPT, max_seq=MAX_SEQ,
                                   standby_split=2, force_mode="recompute",
                                   device="cpu")
    own = {"switch_a": [], "switch_b2": [], "pause_resume": []}
    a_downtime = []
    for round_ in range(3):
        if round_:
            mgr.build_standby(2)
        rep_a = mgr.repartition("switch_a", 2)
        rep_b2 = mgr.repartition("switch_b2", 0)
        rep_pr = mgr.repartition("pause_resume", 2)
        rep_b1 = mgr.repartition("switch_b1", 1)
        for rep in (rep_a, rep_b2, rep_pr):
            assert rep.handoff_mode == "recompute"
            own[rep.strategy].append(own_downtime(rep))
        a_downtime.append(rep_a.downtime)
        assert rep_a.t_build == 0 and rep_a.build_detail is None
        assert rep_b2.t_build > 0 and rep_b2.build_detail.t_weights == 0
        assert rep_pr.full_outage and not rep_b1.full_outage
        assert not rep_a.full_outage and not rep_b2.full_outage
        assert rep_pr.build_detail.t_weights > 0
    best = {k: min(v) for k, v in own.items()}
    assert best["switch_a"] < best["switch_b2"] < best["pause_resume"], best
    assert min(a_downtime) < 0.05
    mgr.close()


def test_export_import_round_trip_identical_logits():
    _, tcfg = _cfgs("dense", num_layers=2)
    mgr, s = make_stateful_manager(tcfg, split=1, net=NetworkModel(20.0),
                                   prompt_len=PROMPT, max_seq=64,
                                   device="cpu")
    mgr.active.process()
    snap = s.snapshot()
    ref, _ = mgr.active.process()
    s.restore(snap)
    payload, nbytes = s.export_layers(0, 2)
    assert nbytes > 0
    s.import_layers(payload)
    got, _ = mgr.active.process()
    assert torch.equal(ref, got)
    mgr.close()


def test_bf16_payload_round_trip_and_corruption():
    _, tcfg = _cfgs("dense", num_layers=2)
    params = init_model(tcfg, dtype=torch.bfloat16, device="cpu")
    mgr, s = make_stateful_manager(tcfg, params, split=1,
                                   net=NetworkModel(20.0), prompt_len=PROMPT,
                                   max_seq=MAX_SEQ, device="cpu")
    mgr.active.process()
    before = {k: v.clone() for k, v in s.cache.items()}
    payload, _ = s.export_layers(0, 2)
    assert payload["k0"][0] == "bfloat16"
    s.import_layers(payload)
    for k, v in s.cache.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, before[k])
    dtype, shape, buf = payload["v1"]
    payload["v1"] = (dtype, shape, bytes([buf[0] ^ 1]) + buf[1:])
    with pytest.raises(HandoffCorrupted):
        s.import_layers(payload)
    mgr.close()


def test_recompute_reproduces_state():
    _, tcfg = _cfgs("dense_gqa", num_layers=2)
    mgr, s = make_stateful_manager(tcfg, split=1, net=NetworkModel(20.0),
                                   prompt_len=PROMPT, max_seq=64,
                                   device="cpu")
    for _ in range(3):
        mgr.active.process()
    tok = s.next_token().clone()
    before = {k: v.clone() for k, v in s.cache.items()}
    s.recompute_layers(0, 2)
    for k, v in s.cache.items():
        np.testing.assert_allclose(v.numpy(), before[k].numpy(), atol=1e-4,
                                   err_msg=k)
    assert torch.equal(s.next_token(), tok)
    mgr.close()


def test_standby_build_warms_the_handoff_and_leaves_the_state():
    """A stateful pool's standby build runs the re-prefill that switching
    to it would run (the moved layers, at the live length) once on
    scratch input, so the switch's hand-off finds its working set cached;
    the session's state is left bit-equal."""
    _, tcfg = _cfgs("dense", num_layers=4)
    mgr, s = make_stateful_manager(tcfg, split=1, net=NetworkModel(20.0),
                                   prompt_len=PROMPT, max_seq=MAX_SEQ,
                                   force_mode="recompute", device="cpu")
    mgr.active.process()
    runner, calls = s.runner, []
    real = runner.recompute_fn

    def spy(u0, u1):
        calls.append((u0, u1))
        return real(u0, u1)
    runner.recompute_fn = spy
    snap = s.snapshot()
    mgr.build_standby(3)
    assert calls == [(1, 3)]                 # layers 1 and 2 move
    after = s.snapshot()
    for k, v in snap["cache"].items():
        assert torch.equal(after["cache"][k], v), k
    for k in ("tokens", "bounds"):
        assert torch.equal(after[k], snap[k]), k
    assert after["pos"] == snap["pos"]
    rep = mgr.repartition("switch_a", 3)
    assert rep.handoff_mode == "recompute" and calls == [(1, 3)] * 2
    del runner.recompute_fn
    mgr.close()


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults do not raise")
    _, tcfg = _cfgs("dense")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(tcfg)
    params = init_model(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        StatefulStageRunner(tcfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_stateful_manager(tcfg, params, split=1, net=NetworkModel(20.0))
    r = StatefulStageRunner(tcfg, params, device="cpu")
    assert r.device.type == "cpu" and r.resolved_decode_impl == "reference"


def test_decode_impl_validation_and_auto_resolution():
    _, tcfg = _cfgs("dense")
    params = init_model(tcfg, device="cpu")
    with pytest.raises(ValueError, match="decode_impl"):
        StatefulStageRunner(tcfg, params, decode_impl="nope", device="cpu")
    r = StatefulStageRunner(tcfg, params, decode_impl="kernel",
                            device="cpu")
    assert r.decode_impl == "kernel" and r.resolved_decode_impl == "kernel"


def test_unported_parts_raise():
    _, tcfg = _cfgs("dense")
    for family in ("moe", "vlm"):
        with pytest.raises(NotImplementedError):
            unit_list(dataclasses.replace(tcfg, family=family))
    # the ssm and hybrid families are ported (tests/test_torch_ssm_serving.py)
    for arch in ("falcon-mamba-7b", "zamba2-7b"):
        assert unit_list(tget(arch))[0] == ("layer", 0)
    with pytest.raises(NotImplementedError):
        PipelineKey(split=1, mesh_shape=(1, 2))
    # fault plans are ported (tests/test_torch_faults.py): the pool keeps one
    plan = object()
    assert PipelinePool(None, NetworkModel(20.0), {},
                        fault_plan=plan).fault_plan is plan
    with pytest.raises(NotImplementedError):
        PipelinePool(None, NetworkModel(20.0), {}, mesh_shape=(2,))
