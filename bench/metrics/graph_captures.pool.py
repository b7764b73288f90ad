"""CUDA-graph captures of decode stages in the window (``graph_captures``,
a program counter): one a stage at each new pipeline's first step.  None
where no stage ran on the card."""


def read(run):
    c = run.counts
    if not c.get("graph_replays", 0) + c.get("graph_eager", 0):
        return None
    return c.get("graph_captures", 0)
