"""Milliseconds per solve of a closed loop through ``plan.solve``: the
window's seconds over the solves completed in it (the window runs from
the first solve's start to the last one's end)."""


def read(run):
    if run.mix["entry"] != "plan" or not run.answered:
        return None
    return 1e3 * run.seconds / len(run.answered)
