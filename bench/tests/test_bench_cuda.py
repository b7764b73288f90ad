"""On the card, at the cells' own size and limits: the check's control
(the reference in fp8, in the program's place) and the faults of
``bench/tests/faults.py`` planted in the program each come out not
correct, where the sound program is.  ``python -m pytest -s -m
requires_cuda bench/tests/test_bench_cuda.py`` from the repository root,
on a machine with the card; each run prints its readings."""
import json

import pytest

from bench.harness.main import run_cell
from bench.tests import faults as F

SEED = 2 ** 31 + 5
SECONDS = 8.0


def _run(cuda, cell, **kw):
    out = run_cell(cell, SEED, SECONDS, False, device=cuda, **kw)
    print(json.dumps({"cell": cell, "correct": out["correct"],
                      "limits": out["limits"],
                      "notes": out.get("notes", {})}), flush=True)
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", ["falcon-mamba-7b.stream",
                                  "zamba2-7b.pool"])
def test_control_fails_at_the_cells_size(cuda, cell):
    out = _run(cuda, cell, control=True)
    lim = out["limits"]["widest_gap"]
    assert not out["correct"] and lim["value"] > lim["limit"]
    assert out["notes"]["program_gap"] <= lim["limit"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
@pytest.mark.parametrize("cell", ["zamba2-7b.pool", "falcon-mamba-7b.pool"])
def test_fault_fails_at_the_cells_size(cuda, monkeypatch, cell, fault):
    getattr(F, fault)(monkeypatch)
    out = _run(cuda, cell)
    assert not out["correct"]
