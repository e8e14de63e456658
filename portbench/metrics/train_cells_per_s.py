"""Cells trained per second: the minibatch rows of the window's epochs
over the window's seconds, evaluation, fetches, callbacks and checkpoints
included."""

MOVES = "train_cells_per_s"


def read(run):
    rows = run.window_epochs * run.steps_per_epoch * run.batch
    return rows / run.window_seconds
