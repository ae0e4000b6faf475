"""Device operations (kernels, copies, sets) in the traced window per
frame completed in it."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    return t.n_device_ops / t.frames
