"""Camera frames completed in the window (tracked and, for keyframes,
estimated) per second, from the window's start to the last of them."""
from portbench.stats import rate


def read(run):
    return rate(run.t0, run.completions)
