"""Mean of the two stage walls of a request (``RequestTiming.t_edge``
unscaled by the modelled edge, plus ``t_cloud``), in ms: the pipeline's
own time, without the wait in the queue."""
from bench.harness import readers


def read(run):
    return readers.mean((r["t_edge"] + r["t_cloud"]) * 1e3
                        for r in run.requests)
