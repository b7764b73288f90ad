"""Whole runs at a tiny size on the CPU: the result line's keys, the
metrics each kind of run reports, and the traffic drawn from the seed."""
import numpy as np
import pytest
import torch

from bench.harness.main import run_cell
from bench.tests.tiny import tiny_cell
from bench.traffic import generator as G

torch.set_num_threads(2)
SEED = 2 ** 33 + 12345                  # more than 32 bits, as the checks'


@pytest.mark.parametrize("cell", ["falcon-mamba-7b.stream",
                                  "zamba2-7b.pool"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    c = tiny_cell(cell, {"widest_gap": 1e-3})
    out = run_cell(cell, SEED, 1.0, trace, device="cpu", cell=c)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "limits"
    assert out["correct"] is True and out["failed"] == 0
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:                       # every end-to-end metric reads
        assert set(out["metrics"]) == names - {"peak_mem_gib"}
    else:
        assert "breakdown" in out and out["device"]["window_s"] > 0
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_requests_from_seed(seed):
    mix = tiny_cell("zamba2-7b.stream").mix
    a = G.requests(mix, seed, 10.0, 96)
    b = G.requests(mix, seed, 10.0, 96)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    assert all(0 < r.due < 10.0 for r in a)
    # the mix's schedule: every seed replays its arrivals and lengths
    other = G.requests(mix, seed + 1, 10.0, 96)
    assert [r.due for r in a] == [r.due for r in other]
    assert [len(r.tokens) for r in a] == [len(r.tokens) for r in other]
    assert not all(np.array_equal(x.tokens, y.tokens)
                   for x, y in zip(a, other))
    # another schedule: the same lengths and gaps in another order
    moved = G.requests(dict(mix, schedule_seed=mix["schedule_seed"] + 1),
                       seed, 10.0, 96)
    assert sorted(len(r.tokens) for r in a) == \
        sorted(len(r.tokens) for r in moved)
    assert [len(r.tokens) for r in a] != [len(r.tokens) for r in moved]
    assert sorted(np.diff([0] + [r.due for r in a]).round(9)) == \
        sorted(np.diff([0] + [r.due for r in moved]).round(9))


@pytest.mark.parametrize("seed", [1, SEED])
def test_sessions_from_seed(seed):
    mix = tiny_cell("falcon-mamba-7b.pool").mix
    a = G.sessions(mix, seed, 96, 64, 3)
    b = G.sessions(mix, seed, 96, 64, 3)
    c = G.sessions(mix, seed + 1, 96, 64, 3)
    for r in range(3):
        rows = [u[r] for u in a]
        assert sorted(len(s.tokens) for s in rows) == \
            sorted(len(u[r].tokens) for u in c)
        assert all(len(s.tokens) + s.n_out <= 64 for s in rows)
    assert all(np.array_equal(x.tokens, y.tokens) and x.n_out == y.n_out
               for ua, ub in zip(a, b) for x, y in zip(ua, ub))
