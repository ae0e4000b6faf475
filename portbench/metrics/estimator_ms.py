"""Host milliseconds a keyframe in the estimator: the span around
``D2Estimator.input_frame``, total over the window past the profiled
part divided by its calls there."""


def read(run):
    total, n = run.probes.total("estimator", run.quiet_t0, run.t_end)
    return total * 1e3 / n if n else None
