"""The 95th percentile of the server's queue wait (admission to bucket
close, ``ServeResult.queue_wait_s``) over every request due in the traced
part whose bucket closed inside it, the part the other per-layer metrics
read."""
from bench.stats import percentile


def read(run):
    if run.mix["entry"] != "server" or run.trace_span is None:
        return None
    lo, hi = run.trace_span
    waits = [r.queue_wait_s for r in run.answered if lo <= r.due and r.due + r.queue_wait_s <= hi]
    return 1e3 * percentile(waits, 95) if waits else None
