"""The work of the ``dense`` family (a test's third family): every layer
an attention block (``flash_attention`` in a prefill, ``flash_decode`` in
a step) and a SwiGLU MLP, then the LM head.  ``bench/work/model.py`` says
what is counted."""
from __future__ import annotations

from bench.kernels import flash_attention, flash_decode
from bench.work.model import by_kind


def dims(port: dict) -> dict:
    d = port["d_model"]
    return {"d": d, "L": port["num_layers"], "V": port["vocab_size"],
            "AH": port["num_heads"], "AKH": port["num_kv_heads"],
            "hd": port.get("head_dim") or d // port["num_heads"],
            "F": port["d_ff"]}


def layer_matmul_flops(g: dict) -> int:
    """Product FLOPs of one layer a token, without the scores."""
    d, hd = g["d"], g["hd"]
    return 2 * d * hd * (2 * g["AH"] + 2 * g["AKH"]) + 2 * 3 * d * g["F"]


def prefill_work(g: dict, lengths, lo: int, hi: int, *,
                 head_rows: int) -> dict:
    """Layers ``[lo, hi)`` over each prompt (all rows in one call of
    ``flash_attention`` a layer) and the head over ``head_rows`` rows."""
    n = hi - lo
    flops, f, b = head_rows * 2 * g["d"] * g["V"], 0, 0
    lengths = [S for S in lengths if S > 0]
    for S in lengths:
        fa, ba = flash_attention.work(1, S, S, g["AH"], g["AKH"], g["hd"])
        flops += n * (S * layer_matmul_flops(g) + fa)
        f += n * fa
        b += n * ba
    calls = {"flash_attention": (n, f, b)} if lengths and n else {}
    return {"model_flops": flops, "calls": calls}


def decode_work(g: dict, positions) -> dict:
    """One step of the live rows at ``positions``, attending over each
    row's ``pos + 1`` live keys."""
    B, L = len(positions), g["L"]
    if not B:
        return {"model_flops": 0, "calls": {}}
    fd, bd = flash_decode.work(sum(p + 1 for p in positions), B, g["AH"],
                               g["AKH"], g["hd"])
    return {"model_flops": B * (L * layer_matmul_flops(g)
                                + 2 * g["d"] * g["V"]) + L * fd,
            "calls": {"flash_decode": (L, L * fd, L * bd)}}


def event_work(g: dict, event: dict) -> dict:
    return by_kind(g, event, prefill_work, decode_work)
