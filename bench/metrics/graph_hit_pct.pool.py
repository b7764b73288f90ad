"""Stage runs of the window's decode steps replayed from a CUDA graph,
over every stage run on the card: ``graph_replays`` / (``graph_replays``
+ ``graph_eager``), program counters (%).  None where no stage ran on the
card."""


def read(run):
    c = run.counts
    n = c.get("graph_replays", 0) + c.get("graph_eager", 0)
    return 100.0 * c.get("graph_replays", 0) / n if n else None
