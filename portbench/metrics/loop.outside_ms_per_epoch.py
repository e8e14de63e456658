"""Milliseconds an epoch of the window spends outside its training pass
(``models/training.py``'s loop: the evaluation of the training set, the
fetch, the callback, the checkpoint's copy and queued write)."""

MOVES = "train_cells_per_s"


def read(run):
    if not run.window_epoch_seconds:
        return None
    outside = run.window_seconds - sum(run.window_epoch_seconds)
    return outside / len(run.window_epoch_seconds) * 1e3
