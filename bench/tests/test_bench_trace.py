"""The traced stretch's arithmetic on made-up records: device intervals
put on the run's clock and merged, and a trace with nothing to read
failing the run."""
import pytest

from bench.harness import trace as T
from bench.harness.trace import summarize

MS = 1_000_000                          # ns


def test_summary_on_the_runs_clock():
    ev = [(T.MARKER, 100 * MS, 101 * MS), ("k", 105 * MS, 109 * MS),
          ("k", 107 * MS, 111 * MS), ("copy", 150 * MS, 300 * MS)]
    s = summarize(ev, 2.0, 2.1, 2.0 - 0.0)   # marker launched at 2.0 s
    assert s.busy_s == pytest.approx(0.006 + 0.05)
    assert s.idle[0] == pytest.approx([2.0, 2.005])


@pytest.mark.parametrize("events", [
    [("k", 1 * MS, 2 * MS)],                           # no marker
    [(T.MARKER, 1 * MS, 2 * MS), ("k", 900 * MS, 901 * MS)]])  # none inside
def test_a_trace_with_nothing_to_read_fails(events):
    with pytest.raises(T.TraceMissing):
        summarize(events, 0.0, 0.5, 0.0)
    summarize(events, 0.0, 0.5, 0.0, require=False)    # on the CPU
