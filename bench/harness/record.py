"""What a run records: the serving loop's spans and sizes on the run's own
clock (seconds from the window's start), the traced stretch's summary,
the program's own spans and counters (a ``--trace 1`` run's), and the
program's outputs that the check compares.  Metric readers
(``bench/metrics/<metric>.py``) read nothing else."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from bench.harness.trace import TraceSummary


@dataclass
class Run:
    cell: str
    seed: int
    seconds: float             # the measured window
    g: dict                    # the configuration's sizes (work.model.dims)
    setup_s: float = 0.0
    # the serving loop, in order; times in seconds on the run's clock
    requests: list = field(default_factory=list)   # due, start, end, ...
    switches: list = field(default_factory=list)   # blocked_s, link_s, ...
    steps: list = field(default_factory=list)      # start, end, positions
    admits: list = field(default_factory=list)   # start, end, length, waited_s
    evicts: list = field(default_factory=list)     # start, end
    recomputes: list = field(default_factory=list)  # start, end, lo, hi, ...
    attempted: int = 0
    failed: int = 0
    tokens: int = 0            # decode tokens committed inside the window
    window_peak_bytes: int = 0
    process_peak_bytes: int = 0
    trace: Optional[TraceSummary] = None
    # the program's spans (``spans.on_run_clock``) and the counters'
    # totals over the window; None and empty in an untraced run
    spans: Optional[list] = None
    counts: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)    # what the check reads

    def events(self):
        """Every recorded unit of work as ``(kind, record)``."""
        for kind, recs in (("request", self.requests), ("step", self.steps),
                           ("admit", self.admits),
                           ("recompute", self.recomputes)):
            for r in recs:
                yield kind, r

    def traced_events(self):
        """The events that lie wholly inside the traced stretch."""
        t = self.trace
        if t is None:
            return
        for kind, r in self.events():
            if r["start"] >= t.host_t0 and r["end"] <= t.host_t1:
                yield kind, r
