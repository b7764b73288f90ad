"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run at a tiny size on the CPU (the harness's
look for a chip is the entry point's, and is skipped here) with one fault
of ``bench/tests/faults.py`` planted in the program.  Sound runs of the
same size read a widest gap of 0 (the program and the reference are both
f32 on the CPU), so any limit above rounding separates them;
``test_bench_cuda.py`` reads the same faults at the cells' own size
against their limits."""
import pytest
import torch

from bench.harness.main import run_cell
from bench.tests import faults as F
from bench.tests.tiny import tiny_cell

torch.set_num_threads(2)
LIMIT = {"widest_gap": 1e-4}
SEED = 2 ** 32 + 77


def _run(cell):
    return run_cell(cell, SEED, 1.0, False, device="cpu",
                    cell=tiny_cell(cell, LIMIT))


@pytest.mark.parametrize("cell", ["falcon-mamba-7b.stream",
                                  "zamba2-7b.stream"])
def test_answer_altered(monkeypatch, cell):
    assert _run(cell)["correct"]
    F.answer_altered(monkeypatch)
    out = _run(cell)
    assert not out["correct"] and out["limits"]["widest_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["falcon-mamba-7b.pool", "zamba2-7b.pool"])
def test_state_unchanged(monkeypatch, cell):
    assert _run(cell)["correct"]
    F.state_unchanged(monkeypatch)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["falcon-mamba-7b.pool", "zamba2-7b.pool"])
def test_half_the_batch_left_out(monkeypatch, cell):
    F.half_the_batch(monkeypatch)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["falcon-mamba-7b.pool", "zamba2-7b.pool"])
def test_token_altered(monkeypatch, cell):
    F.token_altered(monkeypatch)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["falcon-mamba-7b.stream",
                                  "zamba2-7b.pool"])
def test_control_in_the_programs_place(cell):
    """``control`` judges the fp8 reference's tokens through the same
    limit, the program's own reading kept beside."""
    out = run_cell(cell, SEED, 1.0, False, device="cpu", control=True,
                   cell=tiny_cell(cell, LIMIT))
    assert not out["correct"]
    assert out["limits"]["widest_gap"]["value"] > LIMIT["widest_gap"]
    assert out["notes"]["program_gap"] <= LIMIT["widest_gap"]
