"""BENCHMARK.json against the benchmark's contract, and a configuration, a
mix and a metric added as new files only, found by name."""
import json
import re
import shutil

import pytest

from bench.harness import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# The published config.json of each source, one JSON object a line.
CATALOG = S.BENCH / "tests" / "published_configs.jsonl"


@pytest.fixture(scope="module")
def bench():
    return S.load_json(S.ROOT / "BENCHMARK.json")


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_cells(bench):
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    assert all(w["config"] in cfgs and w["chips"] == 1
               and len(w["why"]) <= 200 for w in bench["workloads"])
    for w in bench["workloads"]:
        cell = S.load_cell(w["name"])
        assert (S.BENCH / "drivers" / f"{cell.mix['kind']}.py").exists()
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.limits, f"no limits for {w['name']}"


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"req_p95_ms", "decode_tok_per_s", "downtime_ms",
                        "peak_mem_gib", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (S.BENCH / "metrics" / f"{m['name']}.py").exists()
    layers = set()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (S.BENCH / "metrics" / f"{m['name']}.py").exists()
        layers.add(m["layer"])
        for cell in m["workloads"]:       # each reports what it moves
            c = S.load_cell(cell)
            assert m["moves"] in {x["name"] for x in c.end_to_end}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(0 < len(x) <= 200 for x in layers)


def test_configs_follow_their_source(bench):
    catalog = {}
    with open(CATALOG) as f:
        for line in f:
            r = json.loads(line)
            catalog[r["source_url"]] = r["config"]
    for c in bench["configs"]:
        cfg = S.load_json(S.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        if c["source"] in catalog:
            for k, v in catalog[c["source"]].items():
                assert cfg.get(k) == v, k


def test_added_cell_config_mix_metric(tmp_path, bench):
    """A cell of a new configuration under a new mix, with a new metric,
    needs new files and entries only."""
    root = tmp_path / "co"
    shutil.copytree(S.BENCH, root / "bench")
    b = json.loads(json.dumps(bench))
    cfg = S.load_json(S.ROOT / "bench/configs/falcon-mamba-7b.json")
    cfg["name"] = "falcon-mamba-7b-b"
    (root / "bench/configs/falcon-mamba-7b-b.json").write_text(
        json.dumps(cfg))
    mix = S.load_json(S.ROOT / "bench/traffic/stream.json")
    mix["arrivals"] = {"process": "poisson", "rate": 3.0}
    mix["prompt"] = {"low": 4096, "high": 8192, "step": 256}
    (root / "bench/traffic/stream_long.json").write_text(json.dumps(mix))
    (root / "bench/traffic/stream_long.falcon-mamba-7b-b.json").write_text(
        json.dumps({"check_sample": 2}))
    (root / "bench/metrics/queue_ms.stream.py").write_text(
        "def read(run):\n    return 1.5\n")
    (root / "bench/limits/falcon-mamba-7b-b.stream_long.json").write_text(
        json.dumps({"widest_gap": 1.0}))
    b["configs"].append(dict(b["configs"][0], name="falcon-mamba-7b-b",
                             file="bench/configs/falcon-mamba-7b-b.json"))
    b["workloads"].append({"name": "falcon-mamba-7b-b.stream_long",
                           "config": "falcon-mamba-7b-b",
                           "traffic": "stream_long", "chips": 1,
                           "why": "long prompts"})
    b["per_layer"].append({"name": "queue_ms.stream", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "serving loop", "moves": "req_p95_ms",
                           "workloads": ["falcon-mamba-7b-b.stream_long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = S.load_cell("falcon-mamba-7b-b.stream_long", root=root)
    assert cell.config["name"] == "falcon-mamba-7b-b"
    assert cell.mix["prompt"]["low"] == 4096
    assert cell.mix["check_sample"] == 2
    assert cell.limits == {"widest_gap": 1.0}
    assert "queue_ms.stream" in {m["name"] for m in cell.per_layer}
    assert S.metric_reader("queue_ms.stream", root=root)(None) == 1.5
    assert S.driver(cell.mix["kind"], root=root).run is not None
    # the files that were there are untouched
    for p in S.BENCH.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert (root / "bench" / p.relative_to(S.BENCH)).read_bytes() \
                == p.read_bytes()
