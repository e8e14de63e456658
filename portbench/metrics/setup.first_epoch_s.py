"""Seconds from the call of ``train`` to the first epoch's callback
(``models/api.py``: staging, the eager step, the capture, the first
epoch's training and evaluation)."""

MOVES = "setup_s"


def read(run):
    return run.first_epoch_seconds
