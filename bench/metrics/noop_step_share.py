"""Percent of the solves' loop steps that ran after convergence (the
steps up to the host's next convergence poll): 1 - sum(iterations) /
sum(steps), from each SolveResult of the window."""


def read(run):
    steps = sum(r.steps for r in run.answered)
    if run.mix["entry"] != "plan" or not steps:
        return None
    return 100.0 * (1.0 - sum(r.iterations for r in run.answered) / steps)
