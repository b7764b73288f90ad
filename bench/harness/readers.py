"""Arithmetic the metric readers share (``bench/metrics/<metric>.py``).
Each returns None where the run has nothing to read, and the harness then
leaves the metric out of the line."""
from __future__ import annotations

import statistics

from bench.work import model as M
from bench.work import peaks


def mean(values):
    values = list(values)
    return statistics.fmean(values) if values else None


def quantile(values, q: float):
    """The ``q`` quantile of ``values`` by linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return None
    x = q * (len(v) - 1)
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def request_latencies_ms(run) -> list:
    """Completion less due time of every request due in the window; a
    request never served is left out (it counts in ``failed``)."""
    return [(r["end"] - r["due"]) * 1e3 for r in run.requests]


def downtime_ms(run):
    """Per repartition, the serving loop's blocked wall around it plus the
    link time the benchmark prices for the bytes the hand-off moved; the
    mean over the window's repartitions."""
    return mean((s["blocked_s"] + s.get("link_s", 0.0)) * 1e3
                for s in run.switches)


def traced_work(run) -> dict:
    """Model FLOPs and each kernel's ``(calls, flops, bytes)`` needed by
    the events inside the traced stretch."""
    flops, calls = 0, {}
    for kind, r in run.traced_events():
        w = M.event_work(run.g, dict(r, kind=kind))
        flops += w["model_flops"]
        for name, (n, f, b) in w["calls"].items():
            c = calls.setdefault(name, [0, 0, 0])
            c[0] += n
            c[1] += f
            c[2] += b
    return {"model_flops": flops, "calls": calls}


def roofline_pct(run, kernel: str):
    """The kernel's bound time for the work the traced stretch needed of
    it, over its device time there, in %.  None where it did not run, or
    where the program launched it fewer times than that work takes (the
    work would then not be the kernel's)."""
    t = run.trace
    if t is None or not t.kernel_s.get(kernel):
        return None
    need = traced_work(run)["calls"].get(kernel)
    if not need or t.calls.get(kernel, 0) < need[0]:
        return None
    return 100.0 * peaks.bound_seconds(need[1], need[2]) / t.kernel_s[kernel]


def mfu_pct(run):
    """Model FLOPs of the work the traced stretch completed (the loop's
    records), over the stretch on the loop's clock at the bf16 peak, in
    %: a host-clock reading, the device trace only bounding it."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    flops = traced_work(run)["model_flops"]
    return 100.0 * flops / (t.window_s * peaks.PEAK_FLOPS) if flops else None


def idle_pct(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
