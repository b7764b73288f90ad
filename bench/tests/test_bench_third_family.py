"""A third family added by new files only: a dense GQA family with RoPE
and SwiGLU (``family: dense``, which the port's slot pool serves), its
weights, reference and work (``bench/tests/third_family/``), a tiny
size, a configuration, limits and one ``sessions`` cell, all added to a
copy of ``bench/`` and ``BENCHMARK.json``.  A whole run of the cell on
the CPU is correct, a decode step that returns its state unchanged is
not, and no file that was there changed but ``BENCHMARK.json``."""
import json
import shutil

import torch

from bench.harness import spec as S
from bench.harness.main import run_cell
from bench.tests import faults as F
from bench.tests.tiny import tiny_cell

torch.set_num_threads(2)
HERE = S.BENCH / "tests" / "third_family"
CONFIG, CELL = "qwen2.5-3b", "qwen2.5-3b.pool"
SEED = 2 ** 32 + 91


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_the_family(root):
    bench = root / "bench"
    fam = bench / "families" / "dense"
    fam.mkdir()
    for part in ("weights", "reference", "work"):
        shutil.copy(HERE / f"{part}.py", fam / f"{part}.py")
    shutil.copy(HERE / "config.json", bench / "configs" / f"{CONFIG}.json")
    shutil.copy(HERE / "tiny_port.json",
                bench / "tests" / "tiny_ports" / f"{CONFIG}.json")
    (bench / "limits" / f"{CELL}.json").write_text(
        json.dumps({"widest_gap": 1e-3}))
    b = S.load_json(root / "BENCHMARK.json")
    cfg = S.load_json(HERE / "config.json")
    b["configs"].append({"name": CONFIG, "source": cfg["source"],
                         "file": f"bench/configs/{CONFIG}.json",
                         "reduced": [], "why": "dense GQA, RoPE, SwiGLU"})
    b["workloads"].append({"name": CELL, "config": CONFIG,
                           "traffic": "pool", "chips": 1,
                           "why": "the slot pool on a dense model"})
    for m in b["end_to_end"] + b["per_layer"]:   # as the pools' metrics
        if "zamba2-7b.pool" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))


def test_a_third_family_by_new_files_only(tmp_path, monkeypatch):
    root = tmp_path / "co"
    shutil.copytree(S.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(S.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _files(root)
    _add_the_family(root)

    cell = tiny_cell(CELL, root=root)
    assert cell.config["port"]["family"] == "dense"
    out = run_cell(CELL, SEED, 1.0, False, device="cpu", cell=cell)
    assert out["correct"] is True, out["limits"]
    assert out["limits"]["widest_gap"]["limit"] == 1e-3
    assert out["metrics"]["decode_tok_per_s"]["value"] > 0
    traced = run_cell(CELL, SEED, 1.0, True, device="cpu", cell=cell)
    assert traced["correct"] is True
    assert traced["metrics"]["mfu.pool"]["value"] > 0   # its work, by name

    F.state_unchanged(monkeypatch)
    assert run_cell(CELL, SEED, 1.0, False, device="cpu",
                    cell=cell)["correct"] is False
    monkeypatch.undo()

    after = _files(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {S.Path("BENCHMARK.json")}
