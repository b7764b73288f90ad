"""Process start to the window's start (s): weights, the program's
build, kernel loading and every warm-up."""


def read(run):
    return run.setup_s
