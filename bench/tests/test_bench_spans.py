"""The program's spans set against the device trace: the exact-intersection
attribution of idle time, the device records placed on the run's clock,
each span metric's reader on a made-up run, a traced run at a tiny size
on the CPU with the recorder on, and on the card the two clocks agreeing.
``python -m pytest -s -m requires_cuda bench/tests/test_bench_spans.py``
runs the card's test."""
import json

import pytest
import torch

from bench.harness import spans as SP
from bench.harness import spec as S
from bench.harness import trace as T
from bench.harness.main import run_and_record
from bench.harness.record import Run
from bench.harness.trace import TraceSummary
from bench.tests.tiny import tiny_cell
from bench.tools.trace_spans import clock_excess_ms

SPAN_METRICS = {                        # readers of spans and counters
    "pool": ("step_host_ms.pool", "launches_per_step.pool",
             "syncs_per_step.pool", "park_gbps.pool",
             "handoff_recompute_ms.pool", "idle_host_pct.pool",
             "graph_hit_pct.pool", "graph_captures.pool"),
    "stream": ("idle_host_pct.stream",),
}

MS = 1_000_000                          # ns
SEED = 2 ** 33 + 12345


def _span(i, name, start, end, parent=None, thread=SP.SERVING, **attrs):
    return {"name": name, "thread": thread, "start": start, "end": end,
            "id": i, "parent": parent, "cause": None, "attrs": attrs}


def _run(spans, idle, records=(), t0=0.0, t1=1.0, counts=None):
    run = Run("x.pool", 0, 2.0, {})
    run.trace = TraceSummary(window_s=t1 - t0, busy_s=0.0, kernel_s={},
                             kernel_records={}, device_ops=[], idle=idle,
                             host_t0=t0, host_t1=t1)
    run.trace.records = sorted(records)
    run.spans = spans
    run.counts = counts or {}
    return run


# two steps in [0, 1]: step 1 = gather, edge{embed, wait}, cloud{wait};
# step 2 overlaps a standby build on the worker
SPANS = [
    _span(1, "step", 0.10, 0.50),
    _span(2, "step.gather", 0.10, 0.12, 1),
    _span(3, "step.edge", 0.12, 0.30, 1),
    _span(4, "step.embed", 0.12, 0.15, 3),
    _span(5, "wait", 0.20, 0.30, 3, syncs=1),
    _span(6, "step.cloud", 0.30, 0.48, 1, implicit_syncs=2),
    _span(7, "wait", 0.40, 0.48, 6, syncs=1),
    _span(8, "step", 0.60, 0.90),
    _span(9, "wait", 0.80, 0.90, 8, syncs=1),
    _span(10, "standby_build", 0.70, 1.20, thread="neukonfig-build"),
    _span(11, "park", 1.10, 1.30),
    _span(12, "park.copy", 1.10, 1.20, 11, d2h_bytes=4 * 10 ** 8),
    _span(13, "handoff.recompute", 1.40, 1.46, rows=8, live_rows=3),
    _span(14, "handoff.recompute", 1.50, 1.54),
    _span(15, "admit", -1.0, -0.5),
    _span(16, "admit.prefill", -1.0, -0.7, 15),
    _span(17, "standby_build", -0.4, -0.1),
]


def test_segments_follow_the_deepest_span():
    segs = SP.segments([s for s in SPANS if s["thread"] == SP.SERVING
                        and 0 <= s["start"] < 1])
    assert [(round(a, 6), round(b, 6), n) for a, b, n in segs] == [
        (0.10, 0.12, "step.gather"), (0.12, 0.15, "step.embed"),
        (0.15, 0.20, "step.edge"), (0.20, 0.30, "wait"),
        (0.30, 0.40, "step.cloud"), (0.40, 0.48, "wait"),
        (0.48, 0.50, "step"), (0.60, 0.80, "step"), (0.80, 0.90, "wait")]


def test_idle_by_exact_intersection():
    idle = [[0.0, 0.11], [0.14, 0.16], [0.49, 0.65]]
    got = SP.idle_by_span(idle, SPANS)
    want = {SP.OUTSIDE: 0.10 + 0.10, "step.gather": 0.01,
            "step.embed": 0.01, "step.edge": 0.01, "step": 0.01 + 0.05}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v)


def test_device_records_on_the_runs_clock():
    ev = [(T.MARKER, 100 * MS, 101 * MS), ("k", 105 * MS, 109 * MS),
          ("copy", 150 * MS, 300 * MS), ("late", 400 * MS, 401 * MS)]
    recs = T.device_records(ev, 2.0, 2.1, 2.0)
    assert [n for _, _, n in recs] == ["k", "copy"]
    assert recs[0][:2] == pytest.approx((2.005, 2.009))
    assert recs[1][1] == pytest.approx(2.2)        # not clipped
    assert T.device_records(ev[1:], 2.0, 2.1, 2.0) == []    # no marker


def test_each_reader_on_a_made_up_run():
    recs = [(0.11, 0.13, "k"), (0.2, 0.25, "k"), (0.45, 0.46, "copy"),
            (0.55, 0.56, "k"), (0.61, 0.7, "k")]
    idle = [[0.0, 0.11], [0.14, 0.16], [0.49, 0.65]]
    run = _run(SPANS, idle, recs)
    read = {m: S.metric_reader(m)(run) for m in SPAN_METRICS["pool"]}
    # step 1: 0.40 s less 0.10 + 0.08 waiting; step 2: 0.30 less 0.10
    assert read["step_host_ms.pool"] == pytest.approx((220 + 200) / 2)
    # step 2 overlaps the standby build: step 1 alone, 3 records in it
    assert read["launches_per_step.pool"] == 3
    assert read["syncs_per_step.pool"] == pytest.approx((2 + 2 + 1) / 2)
    assert read["park_gbps.pool"] == pytest.approx(4.0)
    assert read["handoff_recompute_ms.pool"] == pytest.approx(50.0)
    # idle inside program spans, outside waits: 0.01 * 3 + 0.06
    assert read["idle_host_pct.pool"] == pytest.approx(9.0)
    assert S.metric_reader("idle_host_pct.stream")(run) \
        == read["idle_host_pct.pool"]
    notes = SP.notes(run)
    assert notes["idle_by_span"][0][0] == SP.OUTSIDE
    assert notes["setup_spans"] == [["admit", 1, pytest.approx(0.5)],
                                    ["standby_build", 1,
                                     pytest.approx(0.3)]]


def test_readers_read_nothing_without_spans():
    run = _run(SPANS, [[0.0, 0.5]])
    del run.spans
    for m in SPAN_METRICS["pool"] + SPAN_METRICS["stream"]:
        assert S.metric_reader(m)(run) is None, m
    assert SP.notes(run) == {}
    run.trace = None
    run.spans = SPANS
    for m in SPAN_METRICS["pool"] + SPAN_METRICS["stream"]:
        if m not in ("park_gbps.pool", "handoff_recompute_ms.pool"):
            assert S.metric_reader(m)(run) is None, m


@pytest.mark.parametrize("late_s, excess_ms", [(0.0, -0.5), (0.0008, 0.3)])
def test_clock_excess_on_made_up_records(late_s, excess_ms):
    """The serving thread's waits at [0.20, 0.30] and [0.40, 0.48] count
    (the third overlaps the worker's build); a record queued before the
    first ends 0.5 ms before it ends, or, placed late, 0.3 ms after; the
    next step's first launch, starting at the wait's end, is not read."""
    recs = [(0.19, 0.2995 + late_s, "k"), (0.2999, 0.35, "next")]
    run = _run(SPANS, [], recs)
    assert clock_excess_ms(run) == pytest.approx(excess_ms)


@pytest.mark.parametrize("cell", ["zamba2-7b.pool", "falcon-mamba-7b.stream"])
def test_a_traced_run_with_the_recorder_on(cell):
    torch.set_num_threads(2)
    c = tiny_cell(cell, {"widest_gap": 1e-3})
    out, run = run_and_record(cell, SEED, 1.5, True, device="cpu", cell=c)
    assert out["correct"] is True
    names = {s["name"] for s in run.spans}
    notes = SP.notes(run)
    idle = dict(notes["idle_by_span"])
    if cell.endswith(".pool"):
        assert {"step", "step.edge", "step.cloud", "wait", "park",
                "park.copy", "admit", "switch", "handoff"} <= names
        # on the CPU the device never works: the stretch is all idle, and
        # a step's time splits into its child spans
        assert {"step.edge", "step.cloud"} & set(idle)
        read = {m: S.metric_reader(m)(run) for m in SPAN_METRICS["pool"]}
        assert read["launches_per_step.pool"] is None   # no device records
        assert read["step_host_ms.pool"] > 0
        assert read["syncs_per_step.pool"] >= 2
        assert read["idle_host_pct.pool"] > 0
        assert notes["counts"]["syncs"] > 0
        assert dict((k, n) for k, n, _ in notes["setup_spans"])["admit"] \
            == 3
    else:
        assert {"request", "request.edge", "request.cloud", "wait",
                "switch", "switch.build"} <= names
        assert S.metric_reader("idle_host_pct.stream")(run) > 0
    json.dumps(notes)                   # the notes go into the line


@pytest.mark.requires_cuda
def test_the_clocks_agree_on_the_card(cuda):
    """No device record that started before a serving thread's ``wait``
    began ends more than 0.1 ms after the wait ended, on a short traced
    pool run (``clock_excess_ms``)."""
    out, run = run_and_record("falcon-mamba-7b.pool", SEED, 12.0, True,
                              device=cuda)
    excess = clock_excess_ms(run)
    print(json.dumps({"clock_excess_ms": excess,
                      "records": len(run.trace.records),
                      "waits": len(SP.inside(run.spans, SP.WAIT,
                                             run.trace.host_t0,
                                             run.trace.host_t1)),
                      "device": out["device"]}), flush=True)
    assert out["correct"] and excess is not None and excess <= 0.1
