"""The work a cell's traffic needs, event by event, from the configuration
as it is run (``port`` in ``bench/configs/<config>.json``).

Each family's work (``bench/families/<family>/work.py``, found by the
``port``'s ``family``) gives ``dims(port)``, the sizes its formulas use,
and ``event_work(g, event)``: the model FLOPs one event of a run (a
stateless request, an admission, a decode step, a recompute hand-off)
needs and the calls of each kernel with their frozen ``(flops, bytes)``
(``bench/kernels/<kernel>.py``).  Only work the traffic needs is counted:
the live rows of a slot pool, a prompt's own length and not the bucket it
is padded to.  So a share of a peak or a roofline built from it never
counts work the program wastes, and never passes 100%.

Model FLOPs are the products' multiply-adds (2 a weight a token) and the
attention's score and value products (``4 * head_dim`` a live pair and
head); elementwise work and the scans' recurrences are not counted.
"""
from __future__ import annotations

from pathlib import Path

from bench.harness import spec as S


def dims(port: dict, root: Path = S.ROOT) -> dict:
    """The family's sizes of ``port``, with the family and the checkout
    it was found in, which ``event_work`` reads."""
    g = S.family(port["family"], "work", root).dims(port)
    return dict(g, family=port["family"], root=str(root))


def event_work(g: dict, event: dict) -> dict:
    """The work of one recorded event (``kind`` and its sizes)."""
    return S.family(g["family"], "work", Path(g["root"])).event_work(g, event)


def by_kind(g: dict, event: dict, prefill, decode) -> dict:
    """A recorded event's work through a family's ``prefill(g, lengths,
    lo, hi, head_rows=)`` (layers ``[lo, hi)`` over each prompt, the head
    over ``head_rows`` rows) and ``decode(g, positions)`` (one step of the
    live rows at ``positions``)."""
    kind = event["kind"]
    if kind == "request":
        n = event["length"]
        return prefill(g, [n], 0, g["L"], head_rows=n)
    if kind == "admit":
        return prefill(g, [event["length"]], 0, g["L"], head_rows=1)
    if kind == "step":
        return decode(g, event["positions"])
    if kind == "recompute":
        return prefill(g, event["lengths"], event["lo"], event["hi"],
                       head_rows=0)
    return {"model_flops": 0, "calls": {}}
