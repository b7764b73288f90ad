"""The port's fault plans (``repro_torch.core.faults``) against the JAX
package's: every injector's keyed draws and a plan's event log equal the
reference's for the same seed and spec; a failed build retries through
the pool; a corrupted stateful hand-off falls back to masked recompute,
whose logits match the JAX package's on the same weights."""
import dataclasses
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import BandwidthTrace as JTrace  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.pipeline import RequestTiming as JTiming  # noqa: E402
from repro.core.pool import PipelineKey as JKey  # noqa: E402
from repro.core.stateful import make_stateful_manager as jax_manager  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core.executor import BuildExecutor, RetryPolicy  # noqa: E402
from repro_torch.core.network import BandwidthTrace, NetworkModel  # noqa: E402
from repro_torch.core.pipeline import RequestTiming  # noqa: E402
from repro_torch.core.pool import PipelineKey  # noqa: E402
from repro_torch.core.stateful import (HANDOFF_META_KEY,  # noqa: E402
                                       HandoffIntegrityWarning,
                                       make_stateful_manager,
                                       payload_checksum)
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving.sim import SimPool, SimRunner  # noqa: E402

# ``repro.core`` re-exports the function ``faults`` under the module's name
JF = importlib.import_module("repro.core.faults")

SPECS = ["build_fail(p=0.5)", "build_fail(times=2)",
         "build_fail(p=0.3)+slow_cloud(factor=2.0,p=0.5)",
         "handoff_corrupt(p=0.7)", "handoff_corrupt(p=1.0,mode='truncate')",
         "link_outage(at=3,dur=2)+link_flap(at=6,n=2,period=1.5)"]


@pytest.mark.parametrize("seed", [0, 7])
def test_keyed_uniform_equals_reference(seed):
    for parts in [(0, "build", (2, True), 1), (1, "handoff", 5),
                  (2, "cloud", 17), (3, "byte", 0)]:
        assert F._keyed_uniform(seed, *parts) == \
            JF._keyed_uniform(seed, *parts)
    # pool keys hash through their repr: the two packages' keys agree
    assert repr(PipelineKey(3, True)) == repr(JKey(3, True))
    assert F._keyed_uniform(seed, 0, "build", PipelineKey(3, True), 2) == \
        JF._keyed_uniform(seed, 0, "build", JKey(3, True), 2)


def _drive(mod, key_cls, timing_cls, trace_cls, spec, seed):
    """One scripted sequence of every hook on a plan built by ``mod``;
    returns what an observer can read back."""
    plan = mod.faults(spec, seed=seed).arm()
    builds = []
    for split in range(4):
        for _ in range(3):
            try:
                plan.on_build(key_cls(split, split % 2 == 1))
                builds.append(True)
            except mod.InjectedBuildFailure:
                builds.append(False)
    payloads = []
    for epoch in range(6):
        arr = np.arange(16, dtype=np.float32) + epoch
        payload = {"k0": (str(arr.dtype), arr.shape, arr.tobytes()),
                   "v0": (str(arr.dtype), arr.shape, (arr * 2).tobytes())}
        payload[HANDOFF_META_KEY] = (epoch, 16, payload_checksum(payload))
        plan.mutate_handoff(payload, epoch=epoch)
        payloads.append({k: v[2] if k != HANDOFF_META_KEY else v
                         for k, v in payload.items()})
    timings = [plan.perturb_timing(rid, timing_cls(0.01, 0.02, 0.03)).t_cloud
               for rid in range(20)]
    trace = plan.apply_to_trace(trace_cls(steps=[(0.0, 20.0), (5.0, 5.0)]))
    return {"builds": builds, "payloads": payloads, "timings": timings,
            "trace": list(trace.steps),
            "attempts": [plan.build_attempts(key_cls(s, s % 2 == 1))
                         for s in range(4)],
            "events": plan.event_log()}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 11])
def test_plan_outcomes_and_event_log_equal_reference(spec, seed):
    port = _drive(F, PipelineKey, RequestTiming, BandwidthTrace, spec, seed)
    ref = _drive(JF, JKey, JTiming, JTrace, spec, seed)
    assert port == ref
    # and the scripted sequence exercised the injector at all
    if "build_fail" in spec:
        assert False in port["builds"]
    if "handoff_corrupt" in spec:
        assert any("handoff_corrupt" in e for e in port["events"])


def test_spec_grammar_and_arming_match_reference():
    plan = F.faults("build_fail(p=0.3)+link_outage(at=1,dur=2)"
                    "+slow_cloud(factor=2.0)", seed=7)
    assert [type(i).__name__ for i in plan.injectors] == \
        ["BuildFail", "LinkOutage", "SlowCloud"]
    assert F.available_faults() == JF.available_faults()
    assert F.faults("").injectors == ()
    with pytest.raises(ValueError):
        F.faults("handoff_corrupt(mode='sideways')")
    plan = F.faults("build_fail(p=1.0)")
    plan.on_build(PipelineKey(1))                # unarmed: not counted
    assert plan.build_attempts(PipelineKey(1)) == 0
    plan.arm()
    with pytest.raises(F.InjectedBuildFailure):
        plan.on_build(PipelineKey(1))
    # a legacy tuple and the key it spells count as one build
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert plan.build_attempts((1, False)) == 1


def test_build_fail_raises_through_the_pool():
    runner = SimRunner(4)
    net = NetworkModel(20.0)
    plan = F.faults("build_fail(times=1)")
    pool = SimPool(runner, net, fault_plan=plan)
    mgr = PipelineManager(runner, 1, net, None, pool=pool)
    plan.arm()
    with pytest.raises(F.InjectedBuildFailure):
        pool.ensure(2)
    entry, hit = pool.ensure(2)                  # attempt 2 is clean
    assert entry.pipeline.ready and not hit
    assert plan.build_attempts(PipelineKey(2)) == 2
    assert plan.event_log() == ["build_fail key=PipelineKey(split=2, "
                                "owns_weights=False, mesh_shape=None, "
                                "variant='') attempt=1"]
    mgr.close()


def test_build_fail_retries_through_the_pool_executor():
    """A background standby build that fails once is redeemed by the
    executor's retry: the standby lands, the plan counted two attempts."""
    runner = SimRunner(4)
    net = NetworkModel(20.0)
    plan = F.faults("build_fail(times=1)")
    ex = BuildExecutor(retry=RetryPolicy(max_attempts=3, base_s=0.001,
                                         cap_s=0.01))
    pool = SimPool(runner, net, fault_plan=plan, executor=ex)
    mgr = PipelineManager(runner, 1, net, None, pool=pool)
    plan.arm()
    handle = pool.submit_build(3, owns_weights=True, standby=True)
    assert handle.wait(10.0) and handle.error is None
    assert handle.attempts == 2
    assert plan.build_attempts(PipelineKey(3, True)) == 2
    assert pool.wait_standby(10.0).ready
    plan.release()
    mgr.close()


def _stateful_pair(**kw):
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=3)
    tcfg = dataclasses.replace(tget("qwen2.5-3b").reduced(), num_layers=3)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jm, js = jax_manager(cfg, params, split=1, net=JNet(1000.0),
                         prompt_len=8, max_seq=32, decode_impl="reference",
                         **kw)
    tm, ts = make_stateful_manager(
        tcfg, from_numpy(jax.tree.map(np.asarray, params)), split=1,
        net=NetworkModel(1000.0), max_seq=32, decode_impl="reference",
        device="cpu", prompt=np.asarray(js.tokens), **kw)
    return (jm, js), (tm, ts)


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_handoff_falls_back_to_recompute_like_reference(mode):
    (jm, js), (tm, ts) = _stateful_pair(force_mode="transfer")
    for m, s in ((jm, js), (tm, ts)):
        m.active.process({"token": np.asarray(js.next_token())})
    spec = f"handoff_corrupt(p=1.0,mode='{mode}')"
    jm.pool.fault_plan = JF.faults(spec, seed=3).arm()
    tm.pool.fault_plan = F.faults(spec, seed=3).arm()
    for m in (jm, tm):
        with pytest.warns(UserWarning, match="failed validation") as rec:
            m.repartition("switch_b2", 3)
    assert any(w.category is HandoffIntegrityWarning for w in rec)
    jh, th = jm.pool.handoffs[-1], tm.pool.handoffs[-1]
    assert th.fallback and th.mode == "recompute"
    assert (jh.fallback, jh.mode, jh.moved_bytes) == \
        (th.fallback, th.mode, th.moved_bytes)
    assert tm.pool.fault_plan.event_log() == jm.pool.fault_plan.event_log()
    for _ in range(3):                       # recovered state decodes
        tok = np.asarray(js.next_token())
        a, _ = jm.active.process({"token": tok})
        b, _ = tm.active.process({"token": tok})
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4,
                                   rtol=1e-3)
    jm.close()
    tm.close()
