"""Seconds from the process's start to the window's: the counts, the
model, the staging inside ``train``, the first epoch with its eager step
and graph capture, and on a checkout's first run the kernels' build."""

MOVES = "setup_s"


def read(run):
    return run.setup_seconds
