"""95th percentile, over every frame published in the window past the
profiled part, of its time from entering the replay to its publication,
in milliseconds."""
from portbench.stats import percentile


def read(run):
    lat = [d for t, d in run.stats.get("latency_s", []) if t >= run.quiet_t0]
    p = percentile(lat, 95)
    return None if p is None else p * 1e3
