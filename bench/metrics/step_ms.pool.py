"""The window's decode-step walls summed over their count (ms): one
step of every slot through both stages, synchronised."""


def read(run):
    if not run.steps:
        return None
    return sum(s["end"] - s["start"] for s in run.steps) * 1e3 / len(run.steps)
