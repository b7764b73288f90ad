"""Decode tokens committed to live sessions by steps that ended inside
the window, over the window (tokens/s)."""


def read(run):
    return run.tokens / run.seconds if run.steps else None
