"""Quadcam frames whose four point clouds were published in the window,
per second, from the window's start to the last publication."""
from portbench.stats import rate


def read(run):
    return rate(run.t0, run.completions)
