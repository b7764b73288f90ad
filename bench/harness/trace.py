"""The traced stretch of a ``--trace 1`` run: torch.profiler over a fixed
stretch of the measured window, recording the device's activity only
(kernels, copies, sets), summarised in memory; nothing is written to
disk.  Recording the host's operators as well would add microseconds to
each of the thousands a request or a step dispatches, and so stretch the
host-bound walls the trace is there to explain (on the H100, a loop of
3,000 small products took 0.40 s under a device-only trace and 8.8 s
with the host's operators recorded too).

The profiler runs from the start of the run; only the stretch's records
are read.  The device's timestamps are put on the run's clock by a
marker kernel (``torch.cuda._sleep``) launched at a known time on an
idle device when the stretch starts.  ``summarize`` gives:

* ``busy_s``: the union of the device's intervals in the stretch, so
  work that overlaps (a standby built on the pool's worker beside the
  serving thread) counts once (``chip_smoke.py``'s ``profile_step``
  summed each op's own time, which overlap counts twice);
* ``kernel_s`` / ``kernel_records``: device time and records of each of
  the port's kernels, by a part of its name (``KERNEL_NAMES``);
* the ten device operations that took most time;
* ``idle``: the idle intervals, which ``label_idle`` puts down to what
  the serving loop was doing (its own spans) while the device idled.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

KERNEL_NAMES = {               # the port's kernels: a part of their names
    "flash_attention": "flash_attention",
    "flash_decode": "flash_decode",
    "mamba1_scan": "mamba1_",
    "ssd_scan": "ssd_",
}
MARKER = "spin_kernel"         # ``torch.cuda._sleep``'s kernel


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict
    kernel_records: dict
    device_ops: list
    idle: list                 # [start, end] on the run's clock
    host_t0: float = 0.0       # the stretch on the run's clock (seconds)
    host_t1: float = 0.0
    calls: dict = field(default_factory=dict)   # program launch counters
    events: int = 0            # device records the profiler gave


def _device_events(prof):
    """(name, start_ns, end_ns) of every device activity."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            yield e.name(), e.start_ns(), e.start_ns() + e.duration_ns()


def union(intervals) -> list:
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class TraceMissing(RuntimeError):
    """The profiler gave no marker or no device records in the stretch."""


def summarize(events, t0: float, t1: float, marker_t: float,
              require: bool = True) -> TraceSummary:
    """``events`` (name, start_ns, end_ns) over the stretch ``[t0, t1]`` of
    the run's clock; the marker kernel was launched at ``marker_t``.
    With ``require`` (a run on the card), a trace without the marker or
    without a device record in the stretch raises ``TraceMissing``: its
    busy time and idle share would read 0 and 100% for want of records."""
    events = list(events)
    marks = [s for n, s, _ in events if MARKER in n]
    if require and not marks:
        raise TraceMissing(f"no marker kernel among {len(events)} device "
                           "records: the trace cannot be put on the clock")
    base = min(marks) / 1e9 - marker_t if marks else None
    dev = []
    for n, s, e in events:
        if MARKER in n or base is None:
            continue
        s, e = max(s / 1e9 - base, t0), min(e / 1e9 - base, t1)
        if e > s:
            dev.append((s, e, n))
    if require and not dev:
        raise TraceMissing(f"no device record in the stretch [{t0:.3f}, "
                           f"{t1:.3f}] s of {len(events)}")
    busy = union((s, e) for s, e, _ in dev)
    kernel_s, records = defaultdict(float), defaultdict(int)
    by_name = defaultdict(float)
    for s, e, n in dev:
        by_name[n[:160]] += e - s
        for key, part in KERNEL_NAMES.items():
            if part in n:
                kernel_s[key] += e - s
                records[key] += 1
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=t1 - t0, busy_s=sum(e - s for s, e in busy),
        kernel_s=dict(kernel_s), kernel_records=dict(records),
        device_ops=[[n, v] for n, v in top], idle=idle,
        host_t0=t0, host_t1=t1, events=len(events))


def label_idle(summary: TraceSummary, spans) -> list:
    """The stretch's idle time by what the serving loop was doing
    (``spans``: ``(kind, start, end)`` on the run's clock, not
    overlapping; outside them the loop waited for work): the ten
    largest, in seconds."""
    spans = sorted(spans, key=lambda x: x[1])
    idle = defaultdict(float)
    j = 0
    for a, b in summary.idle:
        mid = (a + b) / 2
        while j < len(spans) and spans[j][2] < mid:
            j += 1
        kind = spans[j][0] if j < len(spans) and spans[j][1] <= mid \
            else "waiting"
        idle[kind] += b - a
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])
            ][:10]


class Tracer:
    """Traces one stretch of the window.  The profiler runs from the start
    of the run (``begin``) to its end (``end``), before the program fills
    the card and after the window has closed: on the H100, started inside
    the window with the card nearly full (a slot pool's) it recorded
    nothing, its collection switched off after the stretch
    (``toggle_collection_dynamic``) lost every record, and stopping it
    takes seconds (it parses every record), which inside the window
    stalled the serving loop.  So its collection, which slows the host's
    dispatch of each launch, lasts the whole run, and a traced run's
    host-clock walls read high.  Only the stretch's records are read.
    ``clock`` is the run's clock."""

    def __init__(self, enabled: bool, device, clock):
        self.enabled = enabled
        self.device = device
        self.clock = clock
        self.prof = None
        self.summary = None
        self.host_t0 = self.host_t1 = None
        self.calls_fn = None       # the program's launch counters, if read
        self._calls0 = self._calls1 = {}
        self._marker_t = 0.0

    @property
    def active(self) -> bool:
        return self.host_t0 is not None and self.host_t1 is None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()

    def due(self, now: float, t_from: float, seconds: float,
            end: float) -> bool:
        """Start the traced stretch at ``t_from``, stop it ``seconds``
        after it started or at ``end``; True while it runs."""
        if self.enabled and self.host_t0 is None and now >= t_from:
            self.start()
        elif self.active and (now >= self.host_t0 + seconds or now >= end):
            self.stop()
        return self.active

    def start(self) -> None:
        self._sync()
        self._calls0 = self.calls_fn() if self.calls_fn else {}
        self._marker_t = self.clock()
        if self.device.type == "cuda":
            torch.cuda._sleep(1)
            self._sync()
        self.host_t0 = self.clock()

    def stop(self) -> None:
        self._sync()
        self.host_t1 = self.clock()
        self._calls1 = self.calls_fn() if self.calls_fn else {}

    def end(self) -> None:
        """Stops the profiler once the window has closed, and reads the
        stretch if there was one."""
        if self.prof is None:
            return
        if self.active:
            self.stop()
        self.prof.__exit__(None, None, None)
        if self.host_t0 is not None:
            self.summary = summarize(
                _device_events(self.prof), self.host_t0, self.host_t1,
                self._marker_t, require=self.device.type == "cuda")
            self.summary.calls = {k: v - self._calls0.get(k, 0)
                                  for k, v in self._calls1.items()}
        self.prof = None
