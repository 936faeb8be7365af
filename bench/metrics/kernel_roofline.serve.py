"""Percent of the HBM roofline over the traced buckets of the serving
cell: the least bytes of each bucket's live steps (the operator once a
step, the vectors once per live lane), at 3.35 TB/s, over the device time
of every kernel on the server's stream."""
from bench import roofline


def read(run):
    if run.trace is None:
        return None
    traced = [r for r in run.answered if r.traced]
    return roofline.share(roofline.bucket_bytes(run.cfg, roofline.group_buckets(traced)),
                          run.trace.solver_kernel_s)
