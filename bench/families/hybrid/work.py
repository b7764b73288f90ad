"""The work of the ``hybrid`` family: the ``ssm`` family's stack with one
shared attention + SwiGLU block applied after every ``hybrid_period``-th
layer (zamba2).  ``bench/work/model.py`` says what is counted."""
from __future__ import annotations

from bench.families.ssm import work as ssm
from bench.kernels import flash_attention, flash_decode
from bench.work.model import by_kind


def dims(port: dict) -> dict:
    """The ``ssm`` family's sizes and the shared block's."""
    out = ssm.dims(port)
    d = port["d_model"]
    out["period"] = port["hybrid_period"]
    out.update(AH=port["num_heads"], AKH=port["num_kv_heads"],
               hd=port.get("head_dim") or d // port["num_heads"],
               F=port["d_ff"])
    return out


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


def prefill_work(g: dict, lengths, lo: int, hi: int, *, head_rows: int,
                 h0: bool = False) -> dict:
    """The ``ssm`` family's prefill, and the shared block's applications
    among layers ``[lo, hi)`` over each prompt (all rows in one call of
    ``flash_attention`` an application)."""
    w = ssm.prefill_work(g, lengths, lo, hi, head_rows=head_rows, h0=h0)
    apps = n_apps(g, lo, hi)
    lengths = [S for S in lengths if S > 0]
    if not apps or not lengths:
        return w
    flops, f, b = w["model_flops"], 0, 0
    for S in lengths:
        fa, ba = flash_attention.work(1, S, S, g["AH"], g["AKH"], g["hd"])
        flops += apps * (S * app_matmul_flops(g) + fa)
        f += apps * fa
        b += apps * ba
    return {"model_flops": flops,
            "calls": dict(w["calls"], flash_attention=(apps, f, b))}


def decode_work(g: dict, positions) -> dict:
    """The ``ssm`` family's step, and the shared block's applications,
    attending over each row's ``pos + 1`` live keys."""
    w = ssm.decode_work(g, positions)
    B = len(positions)
    apps = n_apps(g, 0, g["L"])
    if not B or not apps:
        return w
    keys = sum(p + 1 for p in positions)
    fd, bd = flash_decode.work(keys, B, g["AH"], g["AKH"], g["hd"])
    return {"model_flops": w["model_flops"]
            + apps * (B * app_matmul_flops(g) + fd),
            "calls": dict(w["calls"],
                          flash_decode=(apps, apps * fd, apps * bd))}


def event_work(g: dict, event: dict) -> dict:
    return by_kind(g, event, prefill_work, decode_work)
