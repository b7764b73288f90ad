"""The work a cell's traffic needs, event by event, from the configuration
as it is run (``port`` in ``bench/configs/<config>.json``).

``event_work`` turns one event of a run (a stateless request, an
admission, a decode step, a recompute hand-off) into the model FLOPs it
needs and the calls of each kernel with their frozen ``(flops, bytes)``
(``bench/work/kernels.py``).  Only work the traffic needs is counted: the
live rows of a slot pool, a prompt's own length and not the bucket it is
padded to.  So a share of a peak or a roofline built from it never counts
work the program wastes, and never passes 100%.

Model FLOPs are the products' multiply-adds (2 a weight a token) and the
attention's score and value products (``4 * head_dim`` a live pair and
head); elementwise work and the scans' recurrences are not counted.
"""
from __future__ import annotations

from collections import defaultdict

from bench.work import kernels as K


def dims(port: dict) -> dict:
    """The sizes the formulas use, from a configuration's ``port`` group."""
    s = port["ssm"]
    d = port["d_model"]
    di = s.get("expand", 2) * d
    out = {"d": d, "di": di, "N": s["d_state"], "K": s.get("d_conv", 4),
           "V": port["vocab_size"], "L": port["num_layers"],
           "kind": s["kind"], "period": port.get("hybrid_period", 0)}
    if s["kind"] == "mamba1":
        out["R"] = s.get("dt_rank") or -(-d // 16)
    else:
        out["P"] = s.get("head_dim", 64)
        out["H"] = di // out["P"]
    if out["period"]:
        hd = port.get("head_dim") or d // port["num_heads"]
        out.update(AH=port["num_heads"], AKH=port["num_kv_heads"], hd=hd,
                   F=port["d_ff"])
    return out


def layer_matmul_flops(g: dict) -> int:
    """Product FLOPs of one mamba layer a token."""
    d, di, N = g["d"], g["di"], g["N"]
    if g["kind"] == "mamba1":
        R = g["R"]
        return 2 * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
    return 2 * (d * (2 * di + 2 * N + g["H"]) + di * d)


def app_matmul_flops(g: dict) -> int:
    """Product FLOPs of one application of the shared attention block a
    token, without the scores."""
    d, hd = g["d"], g["hd"]
    return 2 * d * hd * (2 * g["AH"] + 2 * g["AKH"]) + 2 * 3 * d * g["F"]


def n_apps(g: dict, lo: int, hi: int) -> int:
    """Shared-block applications among layers ``[lo, hi)`` (one after
    every ``period``-th layer)."""
    p = g["period"]
    return (hi // p - lo // p) if p else 0


def _scan_call(g: dict, B: int, S: int, h0: bool) -> tuple:
    if g["kind"] == "mamba1":
        return "mamba1_scan", K.mamba1_scan(B, S, g["di"], g["N"], h0=h0)
    return "ssd_scan", K.ssd_scan(B, S, g["H"], g["P"], g["N"], h0=h0)


def prefill_work(g: dict, lengths, lo: int, hi: int, *, head_rows: int,
                 h0: bool = False) -> dict:
    """Layers ``[lo, hi)`` over each prompt of ``lengths`` (one batch row
    each, all rows in one call of each kernel a layer), and the head over
    ``head_rows`` rows."""
    calls = defaultdict(lambda: [0, 0, 0])          # name -> calls, F, B
    flops = 0
    apps = n_apps(g, lo, hi)
    lengths = [S for S in lengths if S > 0]
    for S in lengths:
        flops += S * ((hi - lo) * layer_matmul_flops(g))
        name, (f, b) = _scan_call(g, 1, S, h0)
        calls[name][1] += (hi - lo) * f
        calls[name][2] += (hi - lo) * b
        if apps:
            fa, ba = K.flash_attention(1, S, S, g["AH"], g["AKH"], g["hd"])
            flops += apps * (S * app_matmul_flops(g) + fa)
            calls["flash_attention"][1] += apps * fa
            calls["flash_attention"][2] += apps * ba
    if lengths:                     # the rows share one call a layer
        calls[_scan_call(g, 1, 1, h0)[0]][0] += hi - lo
        if apps:
            calls["flash_attention"][0] += apps
    flops += head_rows * 2 * g["d"] * g["V"]
    return {"model_flops": flops, "calls": {k: tuple(v)
                                           for k, v in calls.items()}}


def decode_work(g: dict, positions) -> dict:
    """One decode step of the live rows at ``positions`` (each row's
    position before the step): every layer, the head, and the attention
    over each row's ``pos + 1`` live keys."""
    B = len(positions)
    calls = {}
    if not B:
        return {"model_flops": 0, "calls": calls}
    L = g["L"]
    flops = B * (L * layer_matmul_flops(g) + 2 * g["d"] * g["V"])
    name, (f, b) = _scan_call(g, B, 1, True)
    calls[name] = (L, L * f, L * b)
    apps = n_apps(g, 0, L)
    if apps:
        keys = sum(p + 1 for p in positions)
        fd, bd = K.flash_decode(keys, B, g["AH"], g["AKH"], g["hd"])
        flops += apps * (B * app_matmul_flops(g) + fd)
        calls["flash_decode"] = (apps, apps * fd, apps * bd)
    return {"model_flops": flops, "calls": calls}


def event_work(g: dict, event: dict) -> dict:
    """The work of one recorded event (``kind`` and its sizes)."""
    kind = event["kind"]
    if kind == "request":
        S = event["length"]
        return prefill_work(g, [S], 0, g["L"], head_rows=S)
    if kind == "admit":
        return prefill_work(g, [event["length"]], 0, g["L"], head_rows=1)
    if kind == "step":
        return decode_work(g, event["positions"])
    if kind == "recompute":
        return prefill_work(g, event["lengths"], event["lo"], event["hi"],
                            head_rows=0)
    return {"model_flops": 0, "calls": {}}
