"""Percent of the HBM roofline over the traced solves: the least bytes
their live steps need (``bench.roofline``), at 3.35 TB/s, over the device
time of every kernel on the solver's stream."""
from bench import roofline


def read(run):
    if run.trace is None:
        return None
    its = [r.iterations for r in run.answered if r.traced]
    return roofline.share(roofline.solve_bytes(run.cfg, its), run.trace.solver_kernel_s)
