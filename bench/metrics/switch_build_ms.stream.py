"""Mean ``SwitchReport.t_build`` of the window's repartitions (ms): the
warm build of the target split's stages."""
from bench.harness import readers


def read(run):
    return readers.mean(s["t_build"] * 1e3 for s in run.switches)
