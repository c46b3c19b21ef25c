"""Seconds from the process's start to the window's (imports, weights, build, warm-up)."""


def read(run):
    return run.setup_s
