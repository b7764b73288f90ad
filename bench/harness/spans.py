"""The program's own spans and counters (``repro_torch.core.timing``) set
against the traced stretch's device records, on the run's clock.

The program stamps its spans with ``time.perf_counter``, the clock the
harness's run clock is read from, and the device trace is put on that
clock by the marker kernel (``trace.py``); so a span shifted by the
window's start lies on the same axis as every device interval, and no
further clock machinery is needed.  A run that carries them has:

* ``run.spans``: every span the program recorded, set-up included, as
  ``take_spans`` gives them, with ``start``/``end`` on the run's clock;
* ``run.counts``: the counters' totals over the window;
* ``run.trace.records``: the stretch's device records ``(start, end,
  name)`` on the run's clock (``trace.device_records``).

The harness records them in a ``--trace 1`` run only (``main.run_cell``);
where a run lacks them every function here returns None or nothing.  The
serving loop runs on the main thread; the pool's build worker records
on its own thread.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import defaultdict
from typing import Optional

SERVING = "MainThread"      # the thread the harness's serving loop runs on
OUTSIDE = "outside"         # idle time outside every program span
WAIT = "wait"               # the program blocked on the device


def on_run_clock(spans, t0: float) -> list:
    """``take_spans`` records with their stamps shifted by ``t0`` (the
    window's start on ``perf_counter``) onto the run's clock."""
    return [dict(s, start=s["start"] - t0, end=s["end"] - t0)
            for s in spans]


def _records(run) -> Optional[list]:
    return run.trace.records if run.trace else None


def children_of(spans) -> dict:
    out = defaultdict(list)
    for s in spans:
        out[s["parent"]].append(s)
    return out


def subtree(span, children) -> list:
    """``span`` and every span below it."""
    out, todo = [], [span]
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(children.get(s["id"], ()))
    return out


def inside(spans, name: str, t0: float, t1: float,
           thread: Optional[str] = SERVING) -> list:
    """The spans called ``name`` (on ``thread``, or any) lying wholly in
    ``[t0, t1]``."""
    return [s for s in spans if s["name"] == name and t0 <= s["start"]
            and s["end"] <= t1 and (thread is None or s["thread"] == thread)]


def segments(spans) -> list:
    """``(start, end, name)`` of the deepest span at each moment of one
    thread's spans (which nest), in order; gaps are left out."""
    out, stack = [], []
    t = None

    def close(upto):
        nonlocal t
        while stack and stack[-1]["end"] <= upto:
            top = stack.pop()
            if top["end"] > t:
                out.append((t, top["end"], top["name"]))
                t = top["end"]

    for s in sorted(spans, key=lambda s: (s["start"], -s["end"])):
        close(s["start"])
        if stack and s["start"] > t:
            out.append((t, s["start"], stack[-1]["name"]))
        t = s["start"]
        stack.append(s)
    close(float("inf"))
    return out


def idle_by_span(idle, spans, thread: str = SERVING) -> dict:
    """Each idle interval's time by the deepest span of ``thread`` that
    overlaps it, by exact intersection; time outside every span reads
    ``outside``.  Returns ``{name: seconds}``."""
    segs = segments([s for s in spans if s["thread"] == thread])
    out = defaultdict(float)
    j = 0
    for a, b in sorted(idle):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[OUTSIDE] += (b - a) - covered
    return dict(out)


def _stretch_idle(run) -> Optional[dict]:
    spans, t = run.spans, run.trace
    if spans is None or t is None or t.window_s <= 0:
        return None
    return idle_by_span(t.idle, spans)


def host_ms_per(run, name: str):
    """Mean over the stretch's ``name`` spans of their wall less the
    ``wait`` spans below them (ms)."""
    spans, t = run.spans, run.trace
    if spans is None or t is None:
        return None
    kids = children_of(spans)
    walls = []
    for s in inside(spans, name, t.host_t0, t.host_t1):
        waits = sum(x["end"] - x["start"] for x in subtree(s, kids)
                    if x["name"] == WAIT)
        walls.append(s["end"] - s["start"] - waits)
    return 1e3 * sum(walls) / len(walls) if walls else None


def records_per(run, name: str, exclude: str = "standby_build"):
    """Device records starting inside each of the stretch's ``name``
    spans, over those spans; spans that overlap an ``exclude`` span of any
    thread (work beside the serving loop) are left out."""
    spans, recs, t = run.spans, _records(run), run.trace
    if spans is None or not recs or t is None:      # no device records
        return None
    busy = [s for s in spans if s["name"] == exclude]
    steps = [s for s in inside(spans, name, t.host_t0, t.host_t1)
             if not any(b["start"] < s["end"] and s["start"] < b["end"]
                        for b in busy)]
    if not steps:
        return None
    starts = sorted(r[0] for r in recs)
    n = sum(bisect_right(starts, s["end"]) - bisect_left(starts, s["start"])
            for s in steps)
    return n / len(steps)


def counted_per(run, name: str, counters=("syncs", "implicit_syncs")):
    """The ``counters`` counted at or below each of the stretch's ``name``
    spans, over those spans."""
    spans, t = run.spans, run.trace
    if spans is None or t is None:
        return None
    kids = children_of(spans)
    steps = inside(spans, name, t.host_t0, t.host_t1)
    if not steps:
        return None
    n = sum(x["attrs"].get(c, 0) for s in steps for x in subtree(s, kids)
            for c in counters)
    return n / len(steps)


def window_spans(run, name: str) -> list:
    """The window's ``name`` spans of any thread."""
    spans = run.spans
    if spans is None:
        return []
    return inside(spans, name, 0.0, run.seconds, thread=None)


def idle_host_pct(run):
    """The share of the stretch in which the device idled while the
    serving thread was inside a program span and not waiting on the
    device (%)."""
    by = _stretch_idle(run)
    if by is None:
        return None
    host = sum(v for k, v in by.items() if k not in (OUTSIDE, WAIT))
    return 100.0 * host / run.trace.window_s


def notes(run) -> dict:
    """``idle_by_span`` (the stretch's ten largest, s), ``setup_spans``
    (set-up's top-level spans by name: count and summed wall, s) and
    ``counts`` (the window's totals); empty where the run has no spans."""
    spans = run.spans
    if spans is None:
        return {}
    out = {}
    by = _stretch_idle(run)
    if by is not None:
        out["idle_by_span"] = [[k, v] for k, v in sorted(
            by.items(), key=lambda kv: -kv[1])][:10]
    setup = defaultdict(lambda: [0, 0.0])
    for s in spans:
        if s["parent"] is None and s["end"] <= 0.0:
            setup[s["name"]][0] += 1
            setup[s["name"]][1] += s["end"] - s["start"]
    out["setup_spans"] = [[k, n, w] for k, (n, w) in sorted(
        setup.items(), key=lambda kv: -kv[1][1])][:10]
    out["counts"] = dict(run.counts)
    return out
