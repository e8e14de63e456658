"""Device milliseconds a training step takes, the evaluation left out: the
device operations of the profiled epoch that start inside its
``epoch.train`` span (``models/training.py``: the training pass, from its
dispatch to the fetch of its lower bound; ``models/step.py`` ``TrainEpoch``,
one graph replay a step), over its steps."""

from portbench import spans

MOVES = "train_cells_per_s"


def read(run):
    if run.trace is None:
        return None
    trained = spans.phases(run.trace, "epoch.train")
    if not trained:
        return None
    seconds = spans.device_seconds_in(run.trace, trained)
    return seconds / (len(trained) * run.steps_per_epoch) * 1e3
