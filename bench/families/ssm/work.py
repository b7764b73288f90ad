"""The work of the ``ssm`` family: a stack of Mamba-1 or Mamba-2 layers
(``ssm.kind``), then the LM head.  ``bench/work/model.py`` says what is
counted."""
from __future__ import annotations

from collections import defaultdict

from bench.kernels import mamba1_scan, ssd_scan
from bench.work.model import by_kind


def dims(port: dict) -> dict:
    """The sizes the formulas use, from a configuration's ``port`` group."""
    s = port["ssm"]
    d = port["d_model"]
    di = s.get("expand", 2) * d
    out = {"d": d, "di": di, "N": s["d_state"], "K": s.get("d_conv", 4),
           "V": port["vocab_size"], "L": port["num_layers"],
           "kind": s["kind"]}
    if s["kind"] == "mamba1":
        out["R"] = s.get("dt_rank") or -(-d // 16)
    else:
        out["P"] = s.get("head_dim", 64)
        out["H"] = di // out["P"]
    return out


def layer_matmul_flops(g: dict) -> int:
    """Product FLOPs of one mamba layer a token."""
    d, di, N = g["d"], g["di"], g["N"]
    if g["kind"] == "mamba1":
        R = g["R"]
        return 2 * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
    return 2 * (d * (2 * di + 2 * N + g["H"]) + di * d)


def scan_call(g: dict, B: int, S: int, h0: bool) -> tuple:
    """The scan kernel's name and ``(flops, bytes)`` of one call."""
    if g["kind"] == "mamba1":
        return "mamba1_scan", mamba1_scan.work(B, S, g["di"], g["N"], h0=h0)
    return "ssd_scan", ssd_scan.work(B, S, g["H"], g["P"], g["N"], h0=h0)


def prefill_work(g: dict, lengths, lo: int, hi: int, *, head_rows: int,
                 h0: bool = False) -> dict:
    """Layers ``[lo, hi)`` over each prompt of ``lengths`` (one batch row
    each, all rows in one call of the scan a layer), and the head over
    ``head_rows`` rows."""
    calls = defaultdict(lambda: [0, 0, 0])          # name -> calls, F, B
    flops = 0
    lengths = [S for S in lengths if S > 0]
    for S in lengths:
        flops += S * ((hi - lo) * layer_matmul_flops(g))
        name, (f, b) = scan_call(g, 1, S, h0)
        calls[name][1] += (hi - lo) * f
        calls[name][2] += (hi - lo) * b
    if lengths:                     # the rows share one call a layer
        calls[scan_call(g, 1, 1, h0)[0]][0] += hi - lo
    flops += head_rows * 2 * g["d"] * g["V"]
    return {"model_flops": flops, "calls": {k: tuple(v)
                                           for k, v in calls.items()}}


def decode_work(g: dict, positions) -> dict:
    """One decode step of the live rows at ``positions``: every layer and
    the head."""
    B = len(positions)
    if not B:
        return {"model_flops": 0, "calls": {}}
    L = g["L"]
    name, (f, b) = scan_call(g, B, 1, True)
    return {"model_flops": B * (L * layer_matmul_flops(g)
                                + 2 * g["d"] * g["V"]),
            "calls": {name: (L, L * f, L * b)}}


def event_work(g: dict, event: dict) -> dict:
    return by_kind(g, event, prefill_work, decode_work)
