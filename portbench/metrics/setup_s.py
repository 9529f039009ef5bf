"""Seconds from the start of the process to the start of the window:
imports, the card's context, the kernels' build or load, the traffic's
corpus, the warm-up round trips (host clock)."""


def read(run):
    return run.setup_s
