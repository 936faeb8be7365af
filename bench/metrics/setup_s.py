"""Set-up seconds: process start to the window's start (imports, the
kernel library's load, the operator made from the seed and handed to the
program, the plan or server built and its runners warmed)."""


def read(run):
    return run.setup_s
