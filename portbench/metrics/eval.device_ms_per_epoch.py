"""Device milliseconds an epoch's evaluation takes: the device operations
of the profiled epoch that start inside its ``epoch.evaluate`` span
(``models/training.py``; the whole-set float32 evaluation of
``api._device_evaluator`` and ``step.EvalEpoch``, up to its fetches)."""

from portbench import spans

MOVES = "train_cells_per_s"


def read(run):
    if run.trace is None:
        return None
    epochs = len(spans.phases(run.trace, "epoch.train"))
    evaluated = spans.phases(run.trace, "epoch.evaluate")
    if not epochs or not evaluated:
        return None
    return spans.device_seconds_in(run.trace, evaluated) / epochs * 1e3
