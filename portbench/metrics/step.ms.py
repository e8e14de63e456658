"""Milliseconds a training step takes in the window's epochs: the
program's own seconds of each training pass (``TrainingResult.
epoch_seconds``, from its dispatch to the fetch of its lower bound) over
its steps (``models/step.py`` ``TrainEpoch``: one graph replay a step)."""

MOVES = "train_cells_per_s"


def read(run):
    if not run.window_epoch_seconds:
        return None
    steps = len(run.window_epoch_seconds) * run.steps_per_epoch
    return sum(run.window_epoch_seconds) / steps * 1e3
