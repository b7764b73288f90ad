"""What a run is asked for, found by name from ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.
Everything that belongs to one of them sits in files of its own, found by
name, so that a later change adds a cell, a configuration, a mix or a
metric by adding files and entries alone:

* ``bench/configs/<config>.json``: the configuration (``file`` in its
  ``configs`` entry);
* ``bench/traffic/<mix>.json``: the mix's parameters, and optionally
  ``bench/traffic/<mix>.<config>.json``, the cell's own values (its fixed
  rate, its slot count), merged over them;
* ``bench/drivers/<kind>.py``: the driver of the mix's ``kind``;
* ``bench/metrics/<metric>.py``: one reader a metric;
* ``bench/limits/<cell>.json``: the limits the cell's outputs are held to;
* ``bench/families/<family>/{weights,reference,work}.py``: what depends on
  the architecture, found by the configuration's ``port["family"]``: its
  weights from the seed, its plain reference, its work formulas;
* ``bench/kernels/<kernel>.py``: one file a hand-written kernel of the
  program: the part of its device name a trace is matched by, its launch
  counter, its frozen work formula.

Each is loaded from the checkout the cell was loaded from (``Cell.root``).
"""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]          # the checkout
BENCH = ROOT / "bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """``over`` merged into a copy of ``base``, nested dicts key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict               # bench/configs/<config>.json
    mix_name: str
    mix: dict                  # the mix with the cell's own values merged
    limits: dict
    end_to_end: list           # metric entries this cell reports
    per_layer: list
    run_seconds: int
    root: Path = ROOT          # the checkout it was loaded from


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = root / "bench" / "traffic"
    mix = load_json(traffic / f"{w['traffic']}.json")
    own = traffic / f"{w['traffic']}.{w['config']}.json"
    if own.exists():
        mix = merge(mix, load_json(own))
    limits_path = root / "bench" / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                mix, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                int(bench["run_seconds"]), root)


def metric_reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    mod = load_module(root / "bench" / "metrics" / f"{metric}.py",
                      f"bench_metric_{metric.replace('.', '_')}")
    return mod.read


def driver(kind: str, root: Path = ROOT):
    """The module of ``bench/drivers/<kind>.py``."""
    return load_module(root / "bench" / "drivers" / f"{kind}.py",
                       f"bench_driver_{kind}")


@functools.lru_cache(maxsize=None)
def family(name: str, part: str, root: Path = ROOT):
    """The module of ``bench/families/<name>/<part>.py`` (``weights``,
    ``reference`` or ``work``), loaded once a process."""
    return load_module(root / "bench" / "families" / name / f"{part}.py",
                       f"bench_family_{name}_{part}")


@functools.lru_cache(maxsize=None)
def kernels(root: Path = ROOT) -> dict:
    """``{kernel: module}`` of every ``bench/kernels/<kernel>.py``."""
    return {p.stem: load_module(p, f"bench_kernel_{p.stem}")
            for p in sorted((root / "bench" / "kernels").glob("*.py"))
            if not p.name.startswith("_")}
