"""The 95th percentile of every request due in the window, timed from its
due time to its answer (a request that never came back counts as late
without end)."""
import math

from bench.stats import percentile


def read(run):
    if run.mix.get("loop") != "open" or not run.requests:
        return None
    lat = [(r.done - r.due) if r.done is not None and r.error is None else math.inf
           for r in run.requests]
    p = percentile(lat, 95)
    return None if math.isinf(p) else 1e3 * p
