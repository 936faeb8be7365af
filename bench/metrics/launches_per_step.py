"""Device kernels a loop step: the kernels the profiler saw on the solver's
stream in the traced solves, over those solves' steps (no-op steps and the
start-up's launches included)."""


def read(run):
    if run.trace is None or run.mix["entry"] != "plan":
        return None
    steps = sum(r.steps for r in run.answered if r.traced)
    return run.trace.solver_kernels / steps if steps else None
