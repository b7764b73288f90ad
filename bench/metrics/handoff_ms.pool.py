"""Mean measured wall of the state hand-offs the repartitions executed
(``HandoffReport.t_wall``), in ms."""
from bench.harness import readers


def read(run):
    return readers.mean(s["handoff_wall_s"] * 1e3 for s in run.switches
                        if s["mode"] in ("recompute", "transfer"))
