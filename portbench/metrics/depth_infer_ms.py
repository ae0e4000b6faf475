"""Host milliseconds a frame in the replay's inference stage: the span
around ``DepthReplay._infer`` (what ``DepthReplay.stats["inference"]``
times), total over the window past the profiled part divided by its
calls there."""


def read(run):
    total, n = run.probes.total("depth_infer", run.quiet_t0, run.t_end)
    return total * 1e3 / n if n else None
