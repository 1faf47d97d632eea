"""``frame_p95_ms``: the 95th percentile of every frame of the window,
each timed from its issue to its synchronize (``statistics.quantiles``,
20 parts, the exclusive method)."""
import statistics


def read(run):
    if len(run.latencies) < 2:
        return None
    return 1e3 * statistics.quantiles(run.latencies, n=20)[18]
