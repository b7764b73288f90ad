"""Cells of the benchmark at a size the CPU runs in seconds, for the
tests: the configurations' architectures at tiny widths and depths, the
mixes' shapes at short lengths and a window of a second or two."""
from __future__ import annotations

import copy

from bench.harness import spec as S

PORTS = {
    "falcon-mamba-7b": {
        "name": "falcon-mamba-7b-tiny", "family": "ssm", "num_layers": 3,
        "d_model": 64, "num_heads": 0, "num_kv_heads": 0, "d_ff": 0,
        "vocab_size": 96, "norm_eps": 1e-5,
        "ssm": {"kind": "mamba1", "d_state": 16, "d_conv": 4, "expand": 2,
                "dt_rank": 8}},
    "zamba2-7b": {
        "name": "zamba2-7b-tiny", "family": "hybrid", "num_layers": 4,
        "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 128,
        "vocab_size": 96, "hybrid_period": 2, "rope_theta": 10000.0,
        "norm_eps": 1e-5,
        "ssm": {"kind": "mamba2", "d_state": 16, "d_conv": 4, "expand": 2,
                "head_dim": 16}},
}

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


def tiny_cell(name: str, limits=None) -> S.Cell:
    """The cell ``name`` (``<config>.<mix>``) at the tiny size: one of
    ``BENCHMARK.json``'s, or a pairing of its configurations and mixes
    that it does not benchmark."""
    bench = S.load_json(S.ROOT / "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.rsplit(".", 1)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1})
    cell = S.load_cell(name, bench)
    cell = copy.deepcopy(cell)
    cell.config["port"] = copy.deepcopy(PORTS[cell.config_name])
    cell.config["dtype"] = "float32"
    cell.mix = S.merge(cell.mix, MIXES[cell.mix["kind"]])
    if limits is not None:
        cell.limits = limits
    return cell
