"""The device's idle share of the profiled epoch, in %: 100 × (1 − the
time at least one device operation ran ÷ the time from the epoch's first
device operation to its last)."""

from portbench import trace

MOVES = "train_cells_per_s"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    busy = trace.busy_seconds(run.trace.device)
    return (1.0 - busy / trace.span(run.trace.device)) * 100.0
