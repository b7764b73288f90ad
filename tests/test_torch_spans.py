"""The port's span recorder (``repro_torch.core.timing``): off by default and
then free of records, nesting and parents, a cause across threads,
counters on the innermost span, the spans a tiny CPU slot pool records
(each report field equal to its span's wall), and the port's lint clean
over the instrumented tree."""
import dataclasses
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.cli import main as lint_main
from repro_torch.configs import get_config
from repro_torch.core import timing
from repro_torch.core.network import NetworkModel
from repro_torch.serving.sessions import make_session_manager

MAX_SEQ = 32
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def quiet_recorder():
    timing.tracing(False)
    timing.take_spans()
    timing.take_counts()
    yield
    timing.tracing(False)
    timing.take_spans()
    timing.take_counts()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _children(spans, parent):
    """The names of ``parent``'s children, in the order they started."""
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


def test_off_records_nothing():
    a, b = timing.span("x", k=1), timing.span("y")
    assert a is b is timing.NO_SPAN
    with timing.span("x") as s:
        timing.count("syncs")
        s.set(k=2)
    with timing.timed("t") as t:      # a timed span still times
        pass
    assert t.t1 >= t.t0 > 0 and t.wall == t.t1 - t.t0
    assert timing.current() is None
    assert timing.take_spans() == [] and timing.take_counts() == {}


def test_nesting_and_parents():
    timing.tracing(True)
    with timing.span("a", n=3) as a:
        with timing.span("b") as b:
            with timing.timed("c") as c:
                assert timing.current() == c.id
        with timing.span("d"):
            pass
    timing.tracing(False)
    got = _by_name(timing.take_spans())
    assert [s["name"] for s in sorted(
        [x for v in got.values() for x in v], key=lambda s: s["start"])] \
        == ["a", "b", "c", "d"]
    assert got["a"][0]["parent"] is None and got["a"][0]["attrs"] == {"n": 3}
    assert got["b"][0]["parent"] == a.id
    assert got["c"][0]["parent"] == b.id
    assert got["d"][0]["parent"] == a.id
    for s in (got["b"][0], got["c"][0], got["d"][0]):
        assert got["a"][0]["start"] <= s["start"] <= s["end"] \
            <= got["a"][0]["end"]
    assert got["c"][0]["end"] - got["c"][0]["start"] == c.wall
    assert all(s["thread"] == threading.current_thread().name
               for v in got.values() for s in v)
    assert timing.take_spans() == []         # taken once


def test_a_cause_on_another_thread():
    timing.tracing(True)
    with timing.span("switch") as sw:
        cause = timing.current()

        def work():
            with timing.span("standby_build", cause=cause):
                with timing.span("stage_build"):
                    timing.count("stage_builds")
        th = threading.Thread(target=work, name="worker")
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    got = _by_name(timing.take_spans())
    build = got["standby_build"][0]
    assert build["thread"] == "worker" and build["parent"] is None
    assert build["cause"] == sw.id
    assert got["stage_build"][0]["parent"] == build["id"]
    assert timing.take_counts() == {"stage_builds": 1}


def test_counters_land_on_the_innermost_span():
    timing.tracing(True)
    with timing.span("outer"):
        timing.count("syncs")
        with timing.span("inner"):
            timing.count("syncs", 2)
            timing.count("d2h_bytes", 4096)
    timing.count("syncs")                    # outside every span: total only
    got = _by_name(timing.take_spans())
    assert got["outer"][0]["attrs"] == {"syncs": 1}
    assert got["inner"][0]["attrs"] == {"syncs": 2, "d2h_bytes": 4096}
    assert timing.take_counts() == {"syncs": 4, "d2h_bytes": 4096}


@pytest.fixture(scope="module")
def pool():
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              num_layers=2)
    mgr, sm = make_session_manager(
        cfg, split=0, net=NetworkModel(1000.0), num_slots=3,
        max_seq=MAX_SEQ, standby_split=1, warm_standbys=True,
        force_mode="recompute", device="cpu")
    gen = torch.Generator().manual_seed(0)
    for n in (5, 9):
        sm.admit(torch.randint(0, cfg.vocab_size, (n,), generator=gen))
    yield mgr, sm
    mgr.close()


def test_a_pool_records_its_spans(pool):
    """A decode step, an eviction, an admission and two repartitions on a
    tiny CPU pool: the tree of each, and every report field equal to its
    span's wall."""
    mgr, sm = pool
    timing.tracing(True)
    _, t = mgr.serve(None)
    sid = sm.session_ids()[0]
    sm.evict(sid)
    sm.admit(torch.arange(1, 8))
    rep_a = mgr.repartition("switch_a", 1)
    mgr.drain()
    rep_b = mgr.repartition("switch_b2", 0)
    live = sum(sm.slot_info(s).pos for s in sm.session_ids())
    timing.tracing(False)
    spans = timing.take_spans()
    counts = timing.take_counts()
    got = _by_name(spans)
    ids = {s["id"]: s for s in spans}

    def children(s):
        return _children(spans, s)

    step = got["step"][0]
    assert children(step) == ["step.gather", "step.edge", "step.cloud",
                              "step.commit"]
    edge, cloud = got["step.edge"][0], got["step.cloud"][0]
    assert children(edge) == ["step.embed", "wait"]
    assert children(cloud) == ["step.head", "wait"]
    assert t.t_cloud == cloud["end"] - cloud["start"]
    assert t.t_edge == (edge["end"] - edge["start"]) \
        * mgr.active.edge_scale
    assert step["attrs"] == {} == edge["attrs"]
    assert got["wait"][0]["attrs"] == {"syncs": 1}

    park = got["park"][0]
    assert ids[park["parent"]]["name"] == "evict"
    assert children(park) == ["park.copy", "park.zero"]
    assert got["park.copy"][0]["attrs"]["d2h_bytes"] > 0

    admit = got["admit"][0]
    assert children(admit) == ["admit.prefill", "wait", "admit.rows"]
    assert got["admit.prefill"][0]["attrs"] == {"rows": MAX_SEQ,
                                                "prompt": 7}

    switches = got["switch"]
    assert [s["attrs"]["strategy"] for s in switches] \
        == ["switch_a", "switch_b2"]
    # switch_a: the hand-off, the swap, and the re-armed standby on the
    # pool's build thread, caused by the switch
    assert children(switches[0]) == ["handoff", "switch.activate"]
    rearm = [s for s in got["standby_build"]
             if s["cause"] == switches[0]["id"]]
    assert len(rearm) == 1 and rearm[0]["thread"] != step["thread"]
    assert rep_a.t_background_wall == rearm[0]["end"] - rearm[0]["start"]
    # switch_b2: a warm build, then the hand-off and the swap
    assert children(switches[1]) == ["switch.build", "handoff",
                                     "switch.activate"]
    build = [s for s in got["switch.build"]
             if s["parent"] == switches[1]["id"]][0]
    assert rep_b.t_build == build["end"] - build["start"]
    hand = [s for s in got["handoff"] if s["parent"] == switches[1]["id"]]
    h = mgr.pool.handoffs[-1]
    assert h.t_wall == hand[0]["end"] - hand[0]["start"]
    rec = [s for s in got["handoff.recompute"]
           if s["parent"] == hand[0]["id"]][0]
    assert rec["attrs"]["rows"] == 3 * MAX_SEQ
    assert rec["attrs"]["live_rows"] == live
    assert counts["syncs"] == len(got["wait"])
    assert counts["stage_builds"] == len(got["stage_build"]) > 0


def test_the_ports_lint_is_clean():
    assert lint_main([str(SRC / "repro_torch"), "--no-baseline"]) == 0


def test_a_transfer_hand_off_counts_its_bytes():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    mgr, sm = make_session_manager(
        cfg, split=0, net=NetworkModel(1000.0), num_slots=2,
        max_seq=MAX_SEQ, force_mode="transfer", device="cpu")
    try:
        sm.admit(torch.arange(3, 9))
        timing.tracing(True)
        mgr.repartition("switch_b2", 2)
        timing.tracing(False)
        spans = timing.take_spans()
        got = _by_name(spans)
        h = mgr.pool.handoffs[-1]
        hand = got["handoff"][0]
        assert h.mode == "transfer" and h.moved_bytes > 0
        assert h.t_wall == hand["end"] - hand["start"]
        assert _children(spans, hand) \
            == ["handoff.export", "handoff.import", "wait"]
        assert got["handoff.export"][0]["attrs"] == {
            "d2h_bytes": h.moved_bytes}
        assert got["handoff.import"][0]["attrs"] == {
            "h2d_bytes": h.moved_bytes}
        assert timing.take_counts()["d2h_bytes"] == h.moved_bytes
    finally:
        mgr.close()


def test_a_request_records_its_spans():
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    runner = StageRunner(cfg, T.init_model(cfg, device="cpu"),
                         device="cpu")
    toks = {"tokens": torch.arange(1, 7)[None]}
    mgr = PipelineManager(runner, split=1, net=NetworkModel(100.0),
                          sample_inputs=toks)
    try:
        timing.tracing(True)
        _, t = mgr.serve(toks)
        timing.tracing(False)
        spans = timing.take_spans()
        got = _by_name(spans)
        req = got["request"][0]
        assert _children(spans, req) \
            == ["request.edge", "request.cloud", "request.logits"]
        edge, cloud = got["request.edge"][0], got["request.cloud"][0]
        assert _children(spans, edge) == _children(spans, cloud) == ["wait"]
        assert t.t_cloud == cloud["end"] - cloud["start"]
        assert t.t_edge == (edge["end"] - edge["start"]) \
            * mgr.active.edge_scale
    finally:
        mgr.close()
