"""The port's control plane (``repro_torch.core.controller``,
``repro_torch.core.downtime``) against the JAX package's: the same
``ModelProfile`` and bandwidth trace give the same ``RepartitionEvent``
sequence under every policy, detached and attached to a ``ServingEngine``
on ``SimPool``s; ``simulate_window`` and ``crosscheck_timeline`` give equal
outputs; and on the full-width qwen2.5-3b decode profile (uniform
boundary bytes) the optimum is bandwidth-independent in both."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config  # noqa: E402
from repro.core import controller as JC  # noqa: E402
from repro.core import downtime as JD  # noqa: E402
from repro.core import network as JN  # noqa: E402
from repro.core import profiler as JP  # noqa: E402
from repro.core.partitioner import optimal_split as j_optimal  # noqa: E402
from repro.core.switching import PipelineManager as JManager  # noqa: E402
from repro.serving import clock as JK  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import sim as JS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import controller as C  # noqa: E402
from repro_torch.core import downtime as D  # noqa: E402
from repro_torch.core import network as N  # noqa: E402
from repro_torch.core import profiler as P  # noqa: E402
from repro_torch.core.partitioner import optimal_split  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.serving import clock as K  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving import sim as S  # noqa: E402

PORT = dict(C=C, N=N, P=P, S=S, K=K, E=E, Manager=PipelineManager)
REF = dict(C=JC, N=JN, P=JP, S=JS, K=JK, E=JE, Manager=JManager)
TRACE = [(0.0, 20.0), (4.0, 5.0), (8.0, 0.5), (12.0, 20.0), (16.0, 2.0)]
POLICIES = [None, "hysteresis(min_gain=0.2)", "cooldown(cooldown_s=6.0)",
            "immediate"]


def _profile(m):
    """Six units whose boundary bytes shrink with depth: the optimum moves
    deeper as the link slows (the reference's toy profile, longer)."""
    U = m["P"].UnitProfile
    units = [U("embed", 0.0, 0.0, 4_000_000)]
    units += [U(f"l{i}", 0.02, 0.005, b) for i, b in
              enumerate([2_000_000, 1_000_000, 400_000, 100_000, 20_000])]
    units += [U("head", 0.02, 0.005, 0)]
    return m["P"].ModelProfile("toy", units)


def _sim_manager(m, split=1, clock=None):
    runner = m["S"].SimRunner(6)
    net = m["N"].NetworkModel(20.0)
    pool = m["S"].SimPool(runner, net, build_cost_s=0.25)
    mgr = m["Manager"](runner, split, net, None, pool=pool)
    pool.sim_clock = clock
    return mgr


def _events(events):
    return [(e.t, e.bandwidth_mbps, e.old_split, e.new_split, e.trigger,
             None if e.report is None else
             (e.report.strategy, e.report.old_split, e.report.new_split))
            for e in events]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("strategy", ["switch_b2", "switch_a",
                                      "pause_resume"])
def test_detached_controller_events_equal_reference(strategy, policy):
    out = {}
    for name, m in (("port", PORT), ("ref", REF)):
        mgr = _sim_manager(m)
        ctl = m["C"].NeukonfigController(
            mgr, _profile(m), m["N"].BandwidthTrace(steps=TRACE),
            strategy=strategy, policy=policy)
        out[name] = (_events(ctl.run(duration=20.0)), mgr.active.split)
        mgr.close()
    assert out["port"] == out["ref"]
    assert any(ev[5] is not None for ev in out["port"][0])


@pytest.mark.parametrize("policy", [None, "cooldown(cooldown_s=6.0)"])
def test_engine_controller_timeline_equal_reference(policy):
    """Attached to a ServingEngine on a quantised VirtualClock, the two
    packages' controllers make the same repartitions at the same stream
    times and the timelines serialise byte-identically."""
    out = {}
    for name, m in (("port", PORT), ("ref", REF)):
        clock = m["K"].VirtualClock(quantum=0.5)
        mgr = _sim_manager(m, clock=clock)
        ctl = m["C"].NeukonfigController(
            mgr, _profile(m), m["N"].BandwidthTrace(steps=TRACE),
            strategy="switch_b2", policy=policy, poll_dt=1.0)
        eng = m["E"].ServingEngine(mgr, clock=clock, controller=ctl)
        tl = eng.run(m["E"].request_stream({}, fps=4.0, duration=20.0))
        out[name] = (_events(ctl.events), tl.serialize(), tl.downtime(),
                     tl.switch_drops(wake=1.0))
        mgr.close()
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) > 0


@pytest.mark.parametrize("full_outage", [False, True])
@pytest.mark.parametrize("fps", [2.0, 7.5, 30.0])
def test_simulate_window_equals_reference(fps, full_outage):
    for window in (0.0, 0.01, 0.4, 1.3, 6.0):
        for service in (0.0, 0.02, 0.3):
            a = D.simulate_window(fps=fps, window=window,
                                  service_time=service,
                                  full_outage=full_outage, horizon=8.0)
            b = JD.simulate_window(fps=fps, window=window,
                                   service_time=service,
                                   full_outage=full_outage, horizon=8.0)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(r) for r in D.sweep_fps(
        [1.0, 5.0], window=2.0, service_time=0.1, full_outage=full_outage)] \
        == [dataclasses.asdict(r) for r in JD.sweep_fps(
            [1.0, 5.0], window=2.0, service_time=0.1,
            full_outage=full_outage)]


def test_crosscheck_timeline_equals_reference():
    """Each package's cross-check over its own engine run of the same
    scripted switches (pause_resume: full outages)."""
    out = {}
    for name, m in (("port", PORT), ("ref", REF)):
        clock = m["K"].VirtualClock(quantum=0.5)
        mgr = _sim_manager(m, clock=clock)
        eng = m["E"].ServingEngine(mgr, clock=clock)
        for t, split in ((2.0, 4), (5.0, 2), (8.0, 5)):
            eng.schedule_switch(t, "pause_resume", split)
        tl = eng.run(m["E"].request_stream({}, fps=4.0, duration=10.0))
        xc = (D if m is PORT else JD).crosscheck_timeline(
            tl, fps=4.0, service_time=0.0)
        out[name] = xc
        mgr.close()
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 3 and all(x["full_outage"]
                                         for x in out["port"])


def test_qwen_decode_profile_optimum_is_bandwidth_independent():
    """qwen2.5-3b's decode profile at the slot pool's batch: every split
    ships the same (B, 1, d_model) hidden state, so Eq. 1's optimum does
    not move with the link — split 0 (the cloud takes every layer) at
    each of the trace's bandwidths, in both packages."""
    tcfg, cfg = tget("qwen2.5-3b"), get_config("qwen2.5-3b")
    tp = P.profile_transformer(tcfg, seq=1, batch=4)
    jp = JP.profile_transformer(cfg, seq=1, batch=4)
    assert len({u.boundary_bytes for u in tp.units[:-1]}) == 1
    for bw in (20.0, 5.0, 0.5):
        a = optimal_split(tp, N.NetworkModel(bw))
        b = j_optimal(jp, JN.NetworkModel(bw))
        assert (a.split, a.total) == (b.split, b.total)
        assert a.split == 0


def test_policy_registry_matches_reference():
    assert C.POLICIES.names() == JC.POLICIES.names()
    for spec in POLICIES[1:]:
        assert type(C.get_policy(spec)).__name__ == \
            type(JC.get_policy(spec)).__name__
