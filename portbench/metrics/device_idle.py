"""The traced window's time in which no operation ran on the card
(the complement of the union of its kernels, copies and sets), in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
