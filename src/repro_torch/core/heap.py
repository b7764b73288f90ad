"""The process's long-lived heap, frozen once before the first model.

A full (generation-2) collection of Python's cyclic garbage collector walks
every object the process tracks, on whichever thread trips it.  Nearly all
of them come from the imported modules (torch alone brings ~170,000), live
as long as the process and are never garbage, yet each full collection
walks them again: on an H100 host with a full-width model served, such
collections took 0.10-0.47 s each on the serving thread (PERF.md), in a
decode step, a request or a switch alike.

``freeze_startup_heap`` collects once and moves every object then alive
into the collector's permanent generation (``gc.freeze``), so a later full
collection walks only what was made since: the models, their pipelines
and sessions, whose cyclic garbage (a released pipeline's tensors, a
closed manager) is still found and freed.  ``make_stateful_manager``
calls it first thing, so the first model's build pays the one
collection; a process that builds runners itself calls it before the
first.

It acts once a process, and before any runner exists.  A frozen object
is never collected, and neither is a cycle it belongs to: a runner frozen
with its closures, or a later call that froze live models, would pin
their device tensors for good.  What the caller holds at the first call
(weights it passes in) is frozen with the modules; reference counting
still frees it when dropped, unless a cycle holds it."""
from __future__ import annotations

import gc

_frozen = False


def freeze_startup_heap() -> None:
    """Collect, then freeze every object alive; the first call only."""
    global _frozen
    if _frozen:
        return
    _frozen = True
    gc.collect()
    gc.freeze()
