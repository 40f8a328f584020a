"""Seconds from the process's start to the window's start: imports, the
kernel library's load (its build, in a run that builds), weights and
inputs made on the card, warm-up (host clock)."""


def read(run):
    return run.setup_s
