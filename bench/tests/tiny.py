"""Cells of the benchmark at a size the CPU runs in seconds, for the
tests: the configurations' architectures at tiny widths and depths (one
file a configuration, ``bench/tests/tiny_ports/<config>.json``, the
``port`` group it runs), the mixes' shapes at short lengths and a window
of a second or two."""
from __future__ import annotations

import copy
from pathlib import Path

from bench.harness import spec as S


def port(config: str, root: Path = S.ROOT) -> dict:
    """The tiny ``port`` group of ``config``."""
    return S.load_json(root / "bench" / "tests" / "tiny_ports"
                       / f"{config}.json")


def configs(root: Path = S.ROOT) -> list:
    """The configurations that have a tiny size."""
    return sorted(p.stem for p in
                  (root / "bench" / "tests" / "tiny_ports").glob("*.json"))


MIXES = {
    "requests": {"arrivals": {"rate": 12.0},
                 "prompt": {"low": 16, "high": 64, "step": 8},
                 "switch_first_s": 0.2, "switch_every_s": 0.4,
                 "trace_from_s": 0.1, "trace_seconds": 0.6, "drain_s": 20.0,
                 "check_sample": 3},
    "sessions": {"users": 3, "slots": 3, "max_seq": 64,
                 "prompt": {"low": 8, "high": 32},
                 "output": {"low": 4, "high": 16}, "rounds": 4,
                 "switch_first_s": 0.3, "switch_every_s": 0.6,
                 "trace_from_s": 0.2, "trace_seconds": 0.8,
                 "check_sample": 40},
}


def tiny_cell(name: str, limits=None, root: Path = S.ROOT) -> S.Cell:
    """The cell ``name`` (``<config>.<mix>``) of the checkout ``root`` at
    the tiny size: one of ``BENCHMARK.json``'s, or a pairing of its
    configurations and mixes that it does not benchmark."""
    bench = S.load_json(root / "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.rsplit(".", 1)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1})
    cell = S.load_cell(name, bench, root)
    cell = copy.deepcopy(cell)
    cell.config["port"] = port(cell.config_name, root)
    cell.config["dtype"] = "float32"
    cell.mix = S.merge(cell.mix, MIXES[cell.mix["kind"]])
    if limits is not None:
        cell.limits = limits
    return cell
