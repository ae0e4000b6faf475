"""Host milliseconds a pose-graph solve: the span around the system's
``solve_pgo``, total over the window past the profiled part divided by
the solves there."""


def read(run):
    total, n = run.probes.total("pgo", run.quiet_t0, run.t_end)
    return total * 1e3 / n if n else None
