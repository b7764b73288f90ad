"""NK02 — clock discipline.

Downtime numbers are only reproducible if serving-path timing is
deterministic under ``VirtualClock``.  A stray ``time.perf_counter()``
bypasses the injected stream ``Clock`` entirely: the run still works, but
the reported latency silently depends on host wall time.  So the raw wall
clocks — ``time.perf_counter``, ``time.monotonic``, ``time.time`` (and
their ``_ns`` variants) — are forbidden everywhere in ``src/`` except the
two modules that *define* the sanctioned primitives:

* ``repro_torch/serving/clock.py`` — the stream ``Clock`` hierarchy;
* ``repro_torch/core/timing.py`` — ``Stopwatch`` / ``measure()`` / ``now()``.

Everything else either uses those primitives or carries an explicit
``# nk: allow[NK02]`` (deliberate wall site, e.g. one-time AOT build
timing) or lives in the committed baseline (legacy accepted findings).
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.core import (Finding, Project, Rule, dotted_name,
                                       import_aliases)

WALL_FUNCS = frozenset({
    "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns",
    "time", "time_ns",
})

# path suffixes (forward-slash) where raw wall clocks are the point
ALLOWED_SUFFIXES = (
    "repro_torch/serving/clock.py",
    "repro_torch/core/timing.py",
)


class ClockDisciplineRule(Rule):
    id = "NK02"
    title = "raw wall clock outside sanctioned timing modules"
    severity = "error"

    def run(self, project: Project) -> Iterator[Finding]:
        for module in project.modules:
            if module.path.endswith(ALLOWED_SUFFIXES):
                continue
            aliases = import_aliases(module.tree)
            # names bound directly to wall funcs: from time import perf_counter
            direct: Set[str] = {
                local for local, target in aliases.items()
                if target.startswith("time.")
                and target.split(".", 1)[1] in WALL_FUNCS
            }
            # module aliases for `time` itself: import time [as t]
            time_mods: Set[str] = {
                local for local, target in aliases.items()
                if target == "time"
            }
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                hit = None
                if name in direct:
                    hit = aliases[name]
                elif "." in name:
                    head, _, tail = name.partition(".")
                    if head in time_mods and tail in WALL_FUNCS:
                        hit = f"time.{tail}"
                if hit is None:
                    continue
                yield module.finding(
                    self, node,
                    f"{hit}() bypasses the injected Clock; use "
                    f"Clock.measure()/charge() on the serving path or "
                    f"repro_torch.core.timing (Stopwatch/measure/now) for "
                    f"component timing")
