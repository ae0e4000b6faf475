"""Host milliseconds a frame in the frontend layer: the spans around the
tracker's entries (extraction submit and tracking), total over the
window past the profiled part divided by the frames completed there."""


def read(run):
    total, _ = run.probes.total("frontend", run.quiet_t0, run.t_end)
    frames = sum(1 for t in run.completions if t >= run.quiet_t0)
    return total * 1e3 / frames if frames and total else None
